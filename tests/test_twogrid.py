"""Two-grid Schur preconditioner (neutfem_jax/twogrid.py): SPD, fixed point,
iteration reduction, and decline paths.

The preconditioner must be a FIXED SPD linear operator for CG validity — the
tests materialize the correction as a matrix and check symmetry/positivity
directly, then certify that the preconditioned power iteration reaches the
identical eigenpair with strictly fewer inner iterations on a fine mesh.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import SolveOptions, ctx_group, power_iteration
from neutfem_jax.twogrid import attach_twogrid, twogrid_correction

DT = config.real_dtype


def build_problem(nx=16, ny=12, nz=1, ng=2, k=0, m=0, seed=3):
    rng = np.random.default_rng(seed)
    dim = 2 if nz == 1 else 3
    mesh = CartesianMesh.from_breaks(
        np.linspace(0, nx * 1.9, nx + 1),
        np.linspace(0, ny * 2.2, ny + 1),
        np.linspace(0, nz * 2.0, nz + 1) if dim == 3 else None,
    )
    fes = make_fespace(mesh, k, m)
    fuel = np.zeros(mesh.shape, bool)
    fuel[..., 1:-1, 1:-1] = True
    xs = {
        "D": np.stack([np.where(fuel, 1.4, 1.7), np.where(fuel, 0.4, 0.5)]),
        "SigR": np.stack([rng.uniform(0.025, 0.035, mesh.shape),
                          rng.uniform(0.08, 0.12, mesh.shape)]),
        "NSF": np.stack([np.where(fuel, 0.005, 0.0), np.where(fuel, 0.135, 0.0)]),
        "Chi": np.stack([np.ones(mesh.shape), np.zeros(mesh.shape)]),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    xs["SigS"][1, 0] = np.where(fuel, 0.02, 0.022)
    bcs = BCSpec()
    for ax in range(dim):
        for up in (False, True):
            bcs.set(boundary_attribute(dim, ax, up), BCKind.DIRICHLET)
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    return mesh, fes, ng, xs, bcs, ctx


def _materialize_precond(fes, ctxg, opts, shape):
    """Apply (I + correction) to every unit vector -> explicit matrix."""
    n = int(np.prod(shape))
    cols = []
    for i in range(n):
        e = np.zeros(n, DT)
        e[i] = 1.0
        r = jnp.asarray(e.reshape(shape))
        z = r + twogrid_correction(fes, ctxg, opts, r)
        cols.append(np.asarray(z).reshape(-1))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("mode", ["dense", "cheby"])
def test_correction_is_spd(mode):
    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=8, ny=8)
    attach_twogrid(fes, ng, xs, bcs, ctx, factors=(2, 2, 1), dtype=DT, mode=mode)
    assert "tg" in ctx
    assert ("schur_minv" in ctx["tg"]) == (mode == "dense")
    opts = SolveOptions(inner_precond="twogrid", tg_degree=4)
    ctxg = ctx_group(ctx, 0)
    shape = (fes.P, *mesh.shape)
    M = _materialize_precond(fes, ctxg, opts, shape)
    asym = np.abs(M - M.T).max() / np.abs(M).max()
    # bf16 coarse-inverse storage bounds the dense mode's symmetry/identity
    # roundoff at ~2^-8 of the correction entries
    tol = 5e-5 if mode == "cheby" else 5e-3
    assert asym < tol, f"preconditioner not symmetric: {asym}"
    w = np.linalg.eigvalsh(0.5 * (M + M.T))
    assert w.min() > 0.98, f"preconditioner not positive definite: min eig {w.min()}"


@pytest.mark.parametrize("mode", ["dense", "cheby"])
def test_same_fixed_point_and_fewer_inners(mode):
    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=48, ny=40)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), DT)
    base = SolveOptions(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-8,
                        max_outer=100, inner_precond="jacobi")
    res_j = power_iteration(fes, ng, base, ctx, phi0, 1.0)

    attach_twogrid(fes, ng, xs, bcs, ctx, factors=(4, 4, 1), dtype=DT, mode=mode)
    opts = dataclasses.replace(base, inner_precond="twogrid", tg_degree=8)
    res_t = power_iteration(fes, ng, opts, ctx, phi0, 1.0)

    assert float(res_t["keff"]) == pytest.approx(float(res_j["keff"]), abs=2e-7)
    inners_j = int(res_j["inner_iterations"])
    inners_t = int(res_t["inner_iterations"])
    assert inners_t < inners_j, (
        f"two-grid did not reduce inner iterations: {inners_t} vs {inners_j}")
    # the whole point is a sizable cut on fine meshes
    assert inners_t < 0.75 * inners_j, (inners_t, inners_j)


def test_dense_cap_falls_back_to_cheby():
    """mode='dense' with a coarse space beyond dense_max must build the
    Chebyshev form instead (explicit factors honored)."""
    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=16, ny=12)
    attach_twogrid(fes, ng, xs, bcs, ctx, factors=(2, 2, 1), dtype=DT,
                   mode="dense", dense_max=10)
    assert "schur_minv" not in ctx["tg"] and "schur_lmax" in ctx["tg"]


def test_dense_tg_factors_pick_richest_affordable():
    from neutfem_jax.twogrid import dense_tg_factors

    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=16, ny=12)
    assert dense_tg_factors(mesh, 8192) == (2, 2, 1)  # 8*6 = 48 fits at f=2
    assert dense_tg_factors(mesh, 20) == (4, 4, 1)    # needs f=4 -> 4*3 = 12
    prime_mesh = CartesianMesh.from_breaks(np.linspace(0, 1, 38),
                                           np.linspace(0, 1, 42))
    assert dense_tg_factors(prime_mesh, 8192) == (1, 1, 1)  # 37x41: no factor <= 32


def test_higher_order_block_base():
    """P > 1: the coarse correction rides on top of the block-Jacobi base and
    reaches the same eigenvalue.  (No iteration-count assertion: at P > 1 the
    P_0-mode coarse space covers only a sliver of the block system and the
    additive term can even dilute the block preconditioner on coarse meshes —
    measured +22% inners at 24x20 RT1-P1.  The preconditioner targets RT0 at
    multi-million-cell scale; higher orders keep the block base by default.)"""
    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=24, ny=20, k=1, m=1)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), DT)
    base = SolveOptions(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-8,
                        max_outer=100, inner_precond="block")
    res_b = power_iteration(fes, ng, base, ctx, phi0, 1.0)

    attach_twogrid(fes, ng, xs, bcs, ctx, factors=(4, 4, 1), dtype=DT)
    opts = dataclasses.replace(base, inner_precond="twogrid", tg_degree=6)
    res_t = power_iteration(fes, ng, opts, ctx, phi0, 1.0)
    assert float(res_t["keff"]) == pytest.approx(float(res_b["keff"]), abs=2e-7)


def test_unattached_declines_to_fine_preconditioner():
    """inner_precond='twogrid' without attach_twogrid must behave exactly like
    jacobi (identity on the equilibrated system)."""
    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=12, ny=10)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), DT)
    opts_j = SolveOptions(inner_precond="jacobi")
    opts_t = SolveOptions(inner_precond="twogrid")
    res_j = power_iteration(fes, ng, opts_j, ctx, phi0, 1.0)
    res_t = power_iteration(fes, ng, opts_t, ctx, phi0, 1.0)
    assert float(res_t["keff"]) == float(res_j["keff"])
    assert int(res_t["inner_iterations"]) == int(res_j["inner_iterations"])


def test_jacobi_sweep_batched_correction():
    """The batched (all-groups) sweep path exercises the leading-ng broadcast."""
    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=16, ny=16)
    attach_twogrid(fes, ng, xs, bcs, ctx, factors=(4, 4, 1), dtype=DT)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), DT)
    base = SolveOptions(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-8,
                        max_outer=300, sweep="jacobi", accel="none")
    res_j = power_iteration(fes, ng, base, ctx, phi0, 1.0)
    opts = dataclasses.replace(base, inner_precond="twogrid", tg_degree=6)
    res_t = power_iteration(fes, ng, opts, ctx, phi0, 1.0)
    assert float(res_t["keff"]) == pytest.approx(float(res_j["keff"]), abs=2e-7)


def test_auto_twogrid_rule():
    """The measured-winner auto rule (round 5): 2D >= ~64k cells with a
    dense-affordable coarsening."""
    from neutfem_jax.twogrid import AUTO_TG_MIN_CELLS, auto_twogrid

    fine2d = CartesianMesh.from_breaks(np.linspace(0, 1, 513),
                                       np.linspace(0, 1, 129))   # 65536 cells
    coarse2d = CartesianMesh.from_breaks(np.linspace(0, 1, 101),
                                         np.linspace(0, 1, 101))
    fine3d = CartesianMesh.from_breaks(np.linspace(0, 1, 513),
                                       np.linspace(0, 1, 129),
                                       np.linspace(0, 1, 3))
    prime2d = CartesianMesh.from_breaks(np.linspace(0, 1, 258),
                                        np.linspace(0, 1, 258))  # 257x257
    assert fine2d.n_elements == AUTO_TG_MIN_CELLS and auto_twogrid(fine2d)
    assert not auto_twogrid(coarse2d)     # below the cell threshold
    assert not auto_twogrid(fine3d)       # 3D: measured loss
    assert not auto_twogrid(prime2d)      # no dense-affordable coarsening


def test_auto_resolves_to_twogrid_when_attached():
    """inner_precond='auto' + attached coarse context -> the correction runs
    (fewer inners than the jacobi resolution of the same auto opts)."""
    mesh, fes, ng, xs, bcs, ctx = build_problem(nx=48, ny=40)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), DT)
    opts = SolveOptions(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-8,
                        max_outer=100, inner_precond="auto")
    res_j = power_iteration(fes, ng, opts, ctx, phi0, 1.0)
    attach_twogrid(fes, ng, xs, bcs, ctx, factors=(4, 4, 1), dtype=DT)
    res_t = power_iteration(fes, ng, opts, ctx, phi0, 1.0)
    assert float(res_t["keff"]) == pytest.approx(float(res_j["keff"]), abs=2e-7)
    assert int(res_t["inner_iterations"]) < int(res_j["inner_iterations"])


def test_compat_layer_auto_attaches_on_fine_2d(monkeypatch):
    """The compat layer attaches the dense coarse context when the auto rule
    fires (threshold lowered for test cost), and the solve matches a forced
    jacobi solve."""
    import neutfem_jax.twogrid as tg
    from neutfem import BCType, NeutFEM, VerbosityLevel

    monkeypatch.delenv("NEUTFEM_PRECOND", raising=False)
    monkeypatch.setattr(tg, "AUTO_TG_MIN_CELLS", 1000)
    nx, ny = 64, 32
    s = NeutFEM(0, 2, np.linspace(0.0, 2.0 * nx, nx + 1),
                np.linspace(0.0, 2.0 * ny, ny + 1), np.array([0.0]))
    s.set_verbosity(VerbosityLevel.SILENT)
    for attr in range(1, 5):
        s.set_bc(attr, BCType.DIRICHLET, 0.0)
    D = s.get_D(); D[0], D[1] = 1.4, 0.4
    s.get_SigR()[0], s.get_SigR()[1] = 0.03, 0.10
    s.get_NSF()[0], s.get_NSF()[1] = 0.005, 0.135
    s.get_Chi()[0], s.get_Chi()[1] = 1.0, 0.0
    s.get_SigS()[1, 0] = 0.02
    s.BuildMatrices()
    s.set_tol(1e-7, 1e-6, 1e-6, 200, 1000)
    k_auto = s.SolveKeff()
    assert "tg" in s._ctx_cache["exact"], "auto rule did not attach tg"

    monkeypatch.setenv("NEUTFEM_PRECOND", "jacobi")
    s.reset_flux()
    k_j = s.SolveKeff()
    assert abs(k_auto - k_j) < 5e-7
