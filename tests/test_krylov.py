"""Unit tests for the Krylov layer: fused-reduction CG equivalence + breakdown guards.

The fused variant (Chronopoulos-Gear, krylov.pcg_fused) must agree with textbook PCG
on SPD systems in both float32 and float64, with and without preconditioning; the
breakdown guards must actually be reachable in float32 (round-2 VERDICT Weak #7: the
old 1e-300 literals underflowed to 0.0 in f32 and could never fire).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from neutfem_jax.krylov import bicgstab, pcg, pcg_fused


def _spd_system(n, dtype, seed=0, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.geomspace(1.0, cond, n)
    A = (Q * ev) @ Q.T
    b = rng.standard_normal(n)
    return jnp.asarray(A, dtype), jnp.asarray(b, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("use_precond", [False, True])
def test_pcg_fused_matches_pcg(dtype, use_precond):
    x64_was = jax.config.read("jax_enable_x64")
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        A, b = _spd_system(120, dtype)
        mv = lambda x: A @ x
        pc = (lambda r: r / jnp.diag(A)) if use_precond else None
        x0 = jnp.zeros_like(b)
        tol = 1e-6 if dtype == jnp.float32 else 1e-10

        ref = pcg(mv, b, x0, precond=pc, tol=tol, maxiter=500)
        fus = pcg_fused(mv, b, x0, precond=pc, tol=tol, maxiter=500)

        x_true = jnp.linalg.solve(A.astype(jnp.float64), b.astype(jnp.float64))
        for res in (ref, fus):
            err = np.linalg.norm(np.asarray(res.x, np.float64) - np.asarray(x_true))
            err /= np.linalg.norm(np.asarray(x_true))
            assert err < 50 * tol, (res.iterations, err)
            assert float(res.residual) <= tol * 1.5
        # same convergence class: iteration counts within ~10% of each other
        it_ref, it_fus = int(ref.iterations), int(fus.iterations)
        assert abs(it_ref - it_fus) <= max(8, 0.1 * it_ref), (it_ref, it_fus)
    finally:
        jax.config.update("jax_enable_x64", x64_was)


def test_pcg_warm_start_fused():
    A, b = _spd_system(80, jnp.float32, seed=3)
    mv = lambda x: A @ x
    x_warm = jnp.linalg.solve(A, b) + 1e-3
    ref = pcg(mv, b, x_warm, tol=1e-6, maxiter=400)
    res = pcg_fused(mv, b, x_warm, tol=1e-6, maxiter=400)
    assert int(res.iterations) <= int(ref.iterations) + max(8, 0.1 * int(ref.iterations))
    assert float(res.residual) <= 1.5e-6


def test_breakdown_guard_fires_f32():
    """A singular (zero) operator must trip the f32-reachable breakdown guard:
    finite result, early exit, no NaNs (the old 1e-300 guard span to maxiter)."""
    n = 32
    b = jnp.ones((n,), jnp.float32)
    mv = lambda x: jnp.zeros_like(x)  # A = 0: p.Ap == 0 exactly
    for solver in (pcg, pcg_fused):
        res = solver(mv, b, jnp.zeros_like(b), tol=1e-8, maxiter=100)
        assert int(res.iterations) <= 1, solver.__name__
        assert bool(jnp.all(jnp.isfinite(res.x))), solver.__name__

    res = bicgstab(mv, b, jnp.zeros_like(b), tol=1e-8, maxiter=100)
    assert int(res.iterations) <= 1
    assert bool(jnp.all(jnp.isfinite(res.x)))


def test_zero_rhs_guard():
    A, _ = _spd_system(16, jnp.float32)
    mv = lambda x: A @ x
    b = jnp.zeros((16,), jnp.float32)
    x_warm = jnp.ones_like(b)
    for solver in (pcg, pcg_fused, bicgstab):
        res = solver(mv, b, x_warm, tol=1e-8, maxiter=50)
        assert float(jnp.max(jnp.abs(res.x))) == 0.0, solver.__name__
        assert float(res.residual) == 0.0, solver.__name__


def test_fused_dots_single_reduce():
    """_dots computes k dot products in one variadic reduce and matches vdot."""
    from neutfem_jax.krylov import _dots

    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.standard_normal((7, 13)), jnp.float32)
    z = jnp.asarray(rng.standard_normal((7, 13)), jnp.float32)
    q = jnp.asarray(rng.standard_normal((7, 13)), jnp.float32)
    rz, zq, rr = _dots((r, z), (z, q), (r, r))
    np.testing.assert_allclose(float(rz), float(jnp.vdot(r, z)), rtol=1e-5)
    np.testing.assert_allclose(float(zq), float(jnp.vdot(z, q)), rtol=1e-5)
    np.testing.assert_allclose(float(rr), float(jnp.vdot(r, r)), rtol=1e-5)


def test_dots_complex_conjugation():
    """_dots must keep jnp.vdot's conjugated-first-operand semantics and return
    real scalars (the module docstring promises complex pytrees; the round-3
    fused-reduction refactor briefly dropped both — review finding)."""
    from neutfem_jax.krylov import _dots

    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.standard_normal((4, 6)) + 1j * rng.standard_normal((4, 6)),
                    jnp.complex64)
    b = jnp.asarray(rng.standard_normal((4, 6)) + 1j * rng.standard_normal((4, 6)),
                    jnp.complex64)
    ab, aa = _dots((a, b), (a, a))
    assert not jnp.iscomplexobj(ab) and not jnp.iscomplexobj(aa)
    np.testing.assert_allclose(float(ab), float(jnp.vdot(a, b).real), rtol=1e-5)
    np.testing.assert_allclose(float(aa), float(jnp.vdot(a, a).real), rtol=1e-5)


def test_pcg_complex_operands():
    """pcg with complex operands and a non-identity preconditioner converges
    (exercises the _dots path with complex inputs inside the while_loop)."""
    rng = np.random.default_rng(7)
    B = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    M = jnp.asarray(B @ B.conj().T + 8 * np.eye(8), jnp.complex64)  # HPD
    rhs = jnp.asarray(rng.standard_normal(8) + 1j * rng.standard_normal(8),
                      jnp.complex64)
    diag = jnp.real(jnp.diag(M))
    res = pcg(lambda x: M @ x, rhs, jnp.zeros_like(rhs),
              precond=lambda r: r / diag, tol=1e-6, maxiter=100)
    np.testing.assert_allclose(np.asarray(M @ res.x), np.asarray(rhs),
                               rtol=0, atol=2e-4 * float(jnp.abs(rhs).max()))
