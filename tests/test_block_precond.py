"""P x P block-Jacobi preconditioner of the higher orders: the stored tiers
(ops/context.store_block_inverse — fp8 E-form and bf16 in a float32 solve) and
the apply (power.block_jacobi_apply) against a numpy inverse."""

import jax.numpy as jnp
import numpy as np
import pytest

from neutfem_jax.krylov import pcg
from neutfem_jax.ops.context import store_block_inverse
from neutfem_jax.power import block_jacobi_apply


def _blocks(P, shape, seed=7, scale=0.3):
    """Unit-diagonal SPD blocks (the equilibrated Schur diagonal blocks), one
    per cell, mode-first (P, P, *shape), with their numpy inverse."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(-1.0, 1.0, (*shape, P, P)).astype(np.float32)
    S = 0.5 * (S + np.swapaxes(S, -1, -2)) * (scale / P)
    idx = np.arange(P)
    S[..., idx, idx] = 0.0
    B = S + np.eye(P, dtype=np.float32)
    Binv = np.linalg.inv(B)
    mode_first = lambda a: np.moveaxis(np.moveaxis(a, -1, 0), -1, 0)  # (P, P, *shape)
    return mode_first(B), mode_first(Binv)


@pytest.mark.parametrize("P,shape", [(8, (6, 89, 114)), (4, (1, 520, 64)),
                                     (27, (2, 256, 70))])
@pytest.mark.parametrize("tier", ["fp8", "bf16"])
def test_block_precond_matches_numpy_inverse(P, shape, tier, monkeypatch):
    monkeypatch.setenv("NEUTFEM_BLKFP8", "1" if tier == "fp8" else "0")
    _, Binv = _blocks(P, shape)
    stored = store_block_inverse(jnp.asarray(Binv[None]))
    key = "precond_blk_dev" if tier == "fp8" else "precond_blk_inv"
    assert list(stored) == [key]
    assert stored[key].dtype == (jnp.float8_e4m3fn if tier == "fp8" else jnp.bfloat16)
    ctxg = {k: v[0] for k, v in stored.items()}  # group slice, as ctx_group does
    apply = block_jacobi_apply(ctxg)

    r = np.random.default_rng(3).normal(size=(1, P, *shape)).astype(np.float32)
    got = np.asarray(apply(jnp.asarray(r)), np.float64)
    want = np.einsum("pq...,nq...->np...", Binv.astype(np.float64), r)
    # bound per entry: the storage rounding of each coefficient times |r|.
    # Half an ulp is 2^-4 |c| for e4m3 on E = Binv - I (2^-10 absolute below
    # its smallest normal, 2^-6) and 2^-8 |c| for bf16 on Binv
    coef = Binv - np.eye(P).reshape(P, P, *([1] * len(shape))) if tier == "fp8" else Binv
    if tier == "fp8":
        err = np.maximum(2.0 ** -4 * np.abs(coef), 2.0 ** -10)
    else:
        err = 2.0 ** -8 * np.abs(coef)
    bound = np.einsum("pq...,nq...->np...", err, np.abs(r))
    assert np.all(np.abs(got - want) <= bound + 1e-5 * np.abs(want) + 1e-6)


def test_block_precond_gates(monkeypatch):
    """fp8 falls back to bf16 when E would saturate e4m3; other dtypes keep the
    inverse as it is; a context without blocks has no block apply."""
    monkeypatch.delenv("NEUTFEM_BLKFP8", raising=False)
    _, Binv = _blocks(4, (2, 3, 5))
    big = Binv.copy()
    big[0, 1] = 500.0
    assert list(store_block_inverse(jnp.asarray(big[None]))) == ["precond_blk_inv"]
    assert store_block_inverse(jnp.asarray(big[None]))["precond_blk_inv"].dtype == jnp.bfloat16
    f64 = store_block_inverse(jnp.asarray(Binv[None], jnp.float64))
    assert f64["precond_blk_inv"].dtype == jnp.float64
    assert block_jacobi_apply({"C": jnp.ones(3)}) is None
    # the f64 tier applies the inverse exactly
    r = np.random.default_rng(1).normal(size=(4, 2, 3, 5))
    got = block_jacobi_apply({k: v[0] for k, v in f64.items()})(jnp.asarray(r))
    np.testing.assert_allclose(np.asarray(got), np.einsum("pq...,q...->p...", Binv, r),
                               rtol=1e-5)


def test_pcg_precond_dots_plumbing():
    """pcg with the block preconditioner on a block-diagonal SPD operator:
    with the exact (f64) inverse the first iteration already solves it."""
    P, shape = 8, (2, 3, 4)
    B, Binv = _blocks(P, shape, seed=5)
    B64 = jnp.asarray(B, jnp.float64)
    stored = store_block_inverse(jnp.asarray(Binv[None], jnp.float64))
    apply = block_jacobi_apply({k: v[0] for k, v in stored.items()})
    mv = lambda x: jnp.einsum("pq...,q...->p...", B64, x)
    b = jnp.asarray(np.random.default_rng(9).normal(size=(P, *shape)))
    res = pcg(mv, b, jnp.zeros_like(b), precond=apply, tol=1e-10, maxiter=50)
    assert int(res.iterations) <= 2
    want = np.einsum("pq...,q...->p...", np.asarray(Binv, np.float64), np.asarray(b))
    np.testing.assert_allclose(np.asarray(res.x), want, rtol=1e-5, atol=1e-6)
