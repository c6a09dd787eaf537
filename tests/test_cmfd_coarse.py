"""CMFD acceleration and coarse-grid initialization tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.coarse import coarse_init, coarsen_xs, default_coarse_factors
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import SolveOptions, power_iteration

DT = config.real_dtype


def build_het_problem(nx=12, ny=12, k=0, m=0):
    """Heterogeneous 2-group core: fuel center, reflector ring — a problem where the
    dominance ratio is high enough that acceleration matters."""
    mesh = CartesianMesh.from_breaks(np.linspace(0, 120, nx + 1), np.linspace(0, 120, ny + 1))
    fes = make_fespace(mesh, k, m)
    ng = 2
    fuel = np.zeros(mesh.shape, dtype=bool)
    fuel[:, 2:-2, 2:-2] = True
    D = np.where(fuel, 1.4, 1.8), np.where(fuel, 0.4, 0.5)
    SigR = np.where(fuel, 0.028, 0.021), np.where(fuel, 0.10, 0.04)
    NSF = np.where(fuel, 0.006, 0.0), np.where(fuel, 0.138, 0.0)
    xs = {
        "D": np.stack(D),
        "SigR": np.stack(SigR),
        "NSF": np.stack(NSF),
        "Chi": np.stack([np.ones(mesh.shape), np.zeros(mesh.shape)]),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    xs["SigS"][1, 0] = np.where(fuel, 0.018, 0.020)
    bcs = BCSpec()
    for ax in (0, 1):
        for up in (False, True):
            bcs.set(boundary_attribute(2, ax, up), BCKind.DIRICHLET)
    return mesh, fes, ng, xs, bcs


def test_cmfd_same_keff_fewer_outers():
    mesh, fes, ng, xs, bcs = build_het_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)

    opts_plain = SolveOptions(tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-11, accel="none")
    opts_cmfd = SolveOptions(
        tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-11, accel="none", use_cmfd=True
    )
    res_plain = power_iteration(fes, ng, opts_plain, ctx, phi0, 1.0)
    res_cmfd = power_iteration(fes, ng, opts_cmfd, ctx, phi0, 1.0)

    assert abs(float(res_plain["keff"]) - float(res_cmfd["keff"])) < 1e-7
    assert int(res_cmfd["outer_iterations"]) < int(res_plain["outer_iterations"])


def test_cmfd_with_higher_order():
    """CMFD must also accelerate RT1-P1 (correction applied to all modes)."""
    mesh, fes, ng, xs, bcs = build_het_problem(nx=6, ny=6, k=1, m=1)
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)

    opts = SolveOptions(tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-11, accel="none")
    res_plain = power_iteration(fes, ng, opts, ctx, phi0, 1.0)
    res_cmfd = power_iteration(
        fes, ng,
        SolveOptions(tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-11, accel="none",
                     use_cmfd=True),
        ctx, phi0, 1.0,
    )
    assert abs(float(res_plain["keff"]) - float(res_cmfd["keff"])) < 1e-7


def test_cmfd_vs_chebyshev_same_fixed_point():
    mesh, fes, ng, xs, bcs = build_het_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)
    k_cheb = float(power_iteration(
        fes, ng, SolveOptions(tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-11), ctx, phi0, 1.0
    )["keff"])
    k_cmfd = float(power_iteration(
        fes, ng,
        SolveOptions(tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-11, use_cmfd=True),
        ctx, phi0, 1.0,
    )["keff"])
    assert abs(k_cheb - k_cmfd) < 1e-7


def test_coarsen_xs_volume_weighting():
    mesh = CartesianMesh.from_breaks([0.0, 1.0, 3.0, 4.0, 6.0])  # nonuniform 1D
    xs = {"D": np.array([[[[1.0, 2.0, 3.0, 4.0]]]]), "SigR": np.array([[[[1.0, 1.0, 2.0, 2.0]]]])}
    cmesh, cxs = coarsen_xs(mesh, xs, (2, 1, 1))
    assert cmesh.nx == 2
    # volume weights 1,2 then 1,2: D0 = (1*1 + 2*2)/3, D1 = (3*1 + 4*2)/3
    assert cxs["D"][0, 0, 0, 0] == pytest.approx(5.0 / 3.0)
    assert cxs["D"][0, 0, 0, 1] == pytest.approx(11.0 / 3.0)


def test_default_coarse_factors():
    mesh = CartesianMesh.from_breaks(np.linspace(0, 1, 13), np.linspace(0, 1, 10))
    assert default_coarse_factors(mesh) == (4, 3, 1)


def test_coarse_init_accelerates():
    mesh, fes, ng, xs, bcs = build_het_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    opts = SolveOptions(tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-11)

    k_c, phi0 = coarse_init(fes, ng, xs, bcs, (4, 4, 1), opts, DT)
    assert 0.3 < float(k_c) < 2.0

    res_cold = power_iteration(fes, ng, opts, ctx,
                               jnp.ones((ng, *mesh.shape, fes.P), dtype=DT), 1.0)
    res_warm = power_iteration(fes, ng, opts, ctx, phi0, float(k_c))
    assert abs(float(res_cold["keff"]) - float(res_warm["keff"])) < 1e-7
    # coarse eigenvalue is only an initializer, but must land in the right ballpark
    # (a 3x3 coarse mesh carries O(10%) discretization error on this problem)
    assert abs(float(k_c) - float(res_cold["keff"])) < 0.1
