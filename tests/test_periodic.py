"""True PERIODIC boundary conditions (round-1 VERDICT Missing #5 / task 7).

Verification strategy:
* uniform periodic medium -> k = k_inf exactly (the fundamental mode is flat and
  the cyclic A-solve must not perturb it);
* a periodic lattice whose unit cell is SYMMETRIC equals the MIRROR-bounded
  half-cell problem (classic unit-cell equivalence) — this exercises the seam
  coupling hard, since the periodic problem's flux is non-trivial;
* Sherman-Morrison cyclic solve vs a dense cyclic matrix solve;
* reference bug-parity mode (periodic_natural=True) still warns + acts natural.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.apply import cyc_args, schur_matvec, solve_A_dir
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import SolveOptions, power_iteration

DT = config.real_dtype


def _bcs(dim, periodic_axes=(), mirror_axes=()):
    bcs = BCSpec()
    for ax in range(dim):
        for up in (False, True):
            if ax in periodic_axes:
                kind = BCKind.PERIODIC
            elif ax in mirror_axes:
                kind = BCKind.MIRROR
            else:
                kind = BCKind.DIRICHLET
            bcs.set(boundary_attribute(dim, ax, up), kind)
    return bcs


def _xs_1d(nx, two_region=False):
    ng = 2
    shape = (1, 1, nx)
    D = np.stack([np.full(shape, 1.4), np.full(shape, 0.4)])
    SigR = np.stack([np.full(shape, 0.028), np.full(shape, 0.10)])
    NSF = np.stack([np.full(shape, 0.005), np.full(shape, 0.135)])
    if two_region:
        # symmetric unit cell: absorber band in the middle (indices nx/4..3nx/4)
        lo, hi = nx // 4, 3 * nx // 4
        SigR[1, ..., lo:hi] = 0.16
        NSF[1, ..., lo:hi] = 0.10
        D[0, ..., lo:hi] = 1.1
    Chi = np.stack([np.ones(shape), np.zeros(shape)])
    SigS = np.zeros((ng, ng, *shape))
    SigS[1, 0] = 0.018
    return {"D": D, "SigR": SigR, "NSF": NSF, "Chi": Chi, "SigS": SigS,
            "SRC": np.zeros((ng, *shape))}


def _solve(mesh, xs, bcs, k=0, m=0, **ctx_kw):
    fes = make_fespace(mesh, k, m)
    ng = xs["D"].shape[0]
    ctx = build_context(fes, ng, xs, bcs, dtype=DT, **ctx_kw)
    opts = SolveOptions(tol_keff=1e-10, tol_flux=1e-9, inner_tol=1e-12,
                        max_outer=400)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)
    return power_iteration(fes, ng, opts, ctx, phi0, 1.0), fes, ctx


def _kinf(xs):
    """Two-group k_inf with downscatter: chi=(1,0), production from both groups."""
    sr1, sr2 = xs["SigR"][0].flat[0], xs["SigR"][1].flat[0]
    s12 = xs["SigS"][1, 0].flat[0]
    nf1, nf2 = xs["NSF"][0].flat[0], xs["NSF"][1].flat[0]
    return nf1 / sr1 + nf2 * s12 / (sr1 * sr2)


def test_uniform_periodic_is_kinf():
    nx = 16
    mesh = CartesianMesh.from_breaks(np.linspace(0, 32.0, nx + 1))
    xs = _xs_1d(nx)
    res, _, _ = _solve(mesh, xs, _bcs(1, periodic_axes=(0,)))
    assert float(res["keff"]) == pytest.approx(_kinf(xs), abs=5e-10)
    # the fundamental mode is flat
    phi = np.asarray(res["phi"][..., 0])
    assert np.ptp(phi[0]) / phi[0].max() < 1e-7


def test_periodic_lattice_equals_mirror_half_cell():
    """Symmetric unit cell on [0, L] periodic == MIRROR problem on [0, L/2].
    The periodic eigenfunction is strongly non-flat, so this exercises the
    Sherman-Morrison seam coupling."""
    nx = 32
    L = 64.0
    mesh_p = CartesianMesh.from_breaks(np.linspace(0, L, nx + 1))
    xs_p = _xs_1d(nx, two_region=True)
    res_p, _, _ = _solve(mesh_p, xs_p, _bcs(1, periodic_axes=(0,)))

    # half cell [L/4, 3L/4] contains the absorber band symmetric about L/2...
    # simpler: shift so the unit cell is symmetric about 0: the band spans
    # [L/4, 3L/4], so the cell IS symmetric about L/2 -> mirror problem on
    # [0, L/2] with MIRROR at both ends reproduces the lattice.
    half = nx // 2
    mesh_m = CartesianMesh.from_breaks(np.linspace(0, L / 2, half + 1))
    xs_m = {k: v[..., :half] for k, v in xs_p.items()}
    res_m, _, _ = _solve(mesh_m, xs_m, _bcs(1, mirror_axes=(0,)))

    assert float(res_p["keff"]) == pytest.approx(float(res_m["keff"]), abs=2e-9)
    # flux profiles match on the half cell (normalize to cell 0)
    pp = np.asarray(res_p["phi"][0, 0, 0, :half, 0])
    pm = np.asarray(res_m["phi"][0, 0, 0, :, 0])
    np.testing.assert_allclose(pp / pp[0], pm / pm[0], rtol=1e-6)


def test_periodic_2d_equals_mirror_half():
    """2D: periodic in x, vacuum in y — equals the MIRROR-halved problem."""
    nx, ny = 16, 12
    L = 32.0
    mesh_p = CartesianMesh.from_breaks(np.linspace(0, L, nx + 1),
                                       np.linspace(0, 24.0, ny + 1))
    ng = 2
    shape = (1, ny, nx)
    xs = _xs_1d(nx, two_region=True)
    xs = {k: np.repeat(v, ny, axis=-2) for k, v in xs.items()}
    res_p, _, _ = _solve(mesh_p, xs, _bcs(2, periodic_axes=(0,)))

    half = nx // 2
    mesh_m = CartesianMesh.from_breaks(np.linspace(0, L / 2, half + 1),
                                       np.linspace(0, 24.0, ny + 1))
    xs_m = {k: v[..., :half] for k, v in xs.items()}
    res_m, _, _ = _solve(mesh_m, xs_m, _bcs(2, mirror_axes=(0,)))
    assert float(res_p["keff"]) == pytest.approx(float(res_m["keff"]), abs=2e-9)


def test_cyclic_solve_matches_dense():
    """solve_A_dir with cyc data == dense cyclic-tridiagonal solve."""
    nx = 12
    mesh = CartesianMesh.from_breaks(np.linspace(0, 24.0, nx + 1))
    xs = _xs_1d(nx, two_region=True)
    fes = make_fespace(mesh, 0, 0)
    ctx = build_context(fes, 2, xs, _bcs(1, periodic_axes=(0,)), dtype=jnp.float64)

    et = fes.et
    di = fes.dirs[0]
    g = 0
    alpha = np.asarray(ctx["alpha_d0"][g])[0, 0]  # (nx,)
    K = et.K
    A = np.zeros((nx, nx))
    for e in range(nx):
        f0, f1 = e, (e + 1) % nx
        A[f0, f0] += alpha[e] * K[0, 0]
        A[f1, f1] += alpha[e] * K[1, 1]
        A[f0, f1] += alpha[e] * K[0, 1]
        A[f1, f0] += alpha[e] * K[1, 0]

    rng = np.random.default_rng(0)
    r = rng.normal(size=nx)
    x_dense = np.linalg.solve(A, r)

    # internal layout (T, nz, ny, faces) for the 1D mesh
    rF = jnp.asarray(np.concatenate([r, r[:1]]), jnp.float64)[None, None, None, :]
    # undo the fold double-count: the tied representation expects the rhs split
    # over faces 0 and n; passing all of r[0] at face 0 and 0 at face n is valid.
    rF = rF.at[..., -1].set(0.0)
    ctxg = {k: (v[g] if k.startswith(("C", "alpha_", "tri_", "precond", "cyc_")) else v)
            for k, v in ctx.items()}
    F, _ = solve_A_dir(fes, di, ctxg["tri_dinv_d0"], ctxg.get("tri_l_d0"),
                       ctxg["mask_d0"], ctxg["alpha_d0"], rF, None, "exact",
                       cyc=cyc_args(ctxg, "d0"))
    got = np.asarray(F)[0, 0, 0, :]
    np.testing.assert_allclose(got[:nx], x_dense, rtol=1e-10, atol=1e-12)
    assert got[nx] == pytest.approx(got[0])  # tied face


def test_periodic_parity_mode_warns_and_acts_natural():
    nx = 16
    mesh = CartesianMesh.from_breaks(np.linspace(0, 32.0, nx + 1))
    xs = _xs_1d(nx)
    fes = make_fespace(mesh, 0, 0)
    with pytest.warns(RuntimeWarning, match="periodic_natural"):
        ctx = build_context(fes, 2, xs, _bcs(1, periodic_axes=(0,)), dtype=DT,
                            periodic_natural=True)
    # natural boundary == BCKind.NONE everywhere: same context values
    ctx_none = build_context(fes, 2, xs, BCSpec(), dtype=DT)
    np.testing.assert_allclose(np.asarray(ctx["tri_dinv_d0"]),
                               np.asarray(ctx_none["tri_dinv_d0"]))


def test_periodic_requires_both_ends():
    nx = 8
    mesh = CartesianMesh.from_breaks(np.linspace(0, 16.0, nx + 1))
    xs = _xs_1d(nx)
    fes = make_fespace(mesh, 0, 0)
    bcs = BCSpec()
    bcs.set(boundary_attribute(1, 0, False), BCKind.PERIODIC)
    bcs.set(boundary_attribute(1, 0, True), BCKind.DIRICHLET)
    with pytest.raises(ValueError, match="BOTH ends"):
        build_context(fes, 2, xs, bcs, dtype=DT)


def test_periodic_with_cmfd_converges_same_k():
    nx = 32
    mesh = CartesianMesh.from_breaks(np.linspace(0, 64.0, nx + 1))
    xs = _xs_1d(nx, two_region=True)
    res_ref, _, _ = _solve(mesh, xs, _bcs(1, periodic_axes=(0,)))

    fes = make_fespace(mesh, 0, 0)
    ctx = build_context(fes, 2, xs, _bcs(1, periodic_axes=(0,)), dtype=DT)
    opts = SolveOptions(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-11,
                        use_cmfd=True, max_outer=400)
    phi0 = jnp.ones((2, *mesh.shape, fes.P), dtype=DT)
    res = power_iteration(fes, 2, opts, ctx, phi0, 1.0)
    assert float(res["keff"]) == pytest.approx(float(res_ref["keff"]), abs=2e-8)
