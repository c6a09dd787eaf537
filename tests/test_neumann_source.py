"""Nonzero NEUMANN (prescribed inward current) — round-1 VERDICT Missing #4.

The reference accepts NEUMANN values and silently ignores them
(ApplyBoundaryConditions is an empty stub, NeutFEM.cpp:2128-2131; the accepting
surface is wrapper.cpp:401-423).  Here the value is an inhomogeneous essential
condition on the current DOF, lifted as J = J' + J_q with a precomputed fixed
flux-space source (ops/context.py).

Analytic check: 1D pure-absorber slab [0, a], incoming current q on the left,
MIRROR on the right:  phi(x) = q cosh(kappa (a-x)) / (D kappa sinh(kappa a)),
and global balance: total absorption = q."""

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import SolveOptions, fixed_source_solve

DT = config.real_dtype


def _slab(nx=200, a=40.0, D=1.2, siga=0.05, q=1.0):
    mesh = CartesianMesh.from_breaks(np.linspace(0.0, a, nx + 1))
    fes = make_fespace(mesh, 0, 0)
    ng = 1
    xs = {
        "D": np.full((ng, *mesh.shape), D),
        "SigR": np.full((ng, *mesh.shape), siga),
        "NSF": np.zeros((ng, *mesh.shape)),
        "Chi": np.ones((ng, *mesh.shape)),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    bcs = BCSpec()
    bcs.set(boundary_attribute(1, 0, False), BCKind.NEUMANN, q)
    bcs.set(boundary_attribute(1, 0, True), BCKind.MIRROR)
    ctx = build_context(fes, ng, xs, bcs, dtype=DT)
    return mesh, fes, ng, ctx


def test_neumann_analytic_slab_and_balance():
    nx, a, D, siga, q = 200, 40.0, 1.2, 0.05, 1.0
    mesh, fes, ng, ctx = _slab(nx, a, D, siga, q)
    opts = SolveOptions(tol_flux=1e-11, inner_tol=1e-13, max_outer=50)
    phi0 = jnp.zeros((ng, *mesh.shape, fes.P), dtype=DT)
    res = fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=False)
    phi = np.asarray(res["phi"][0, 0, 0, :, 0])

    # global balance: sum(siga * phi * V) == q (incoming per unit transverse area)
    h = a / nx
    absorbed = float(np.sum(siga * phi * h))
    assert absorbed == pytest.approx(q, rel=1e-8)

    # pointwise vs the analytic profile (cell averages; O(h^2) discretization)
    kappa = np.sqrt(siga / D)
    xc = (np.arange(nx) + 0.5) * h
    exact = q * np.cosh(kappa * (a - xc)) / (D * kappa * np.sinh(kappa * a))
    np.testing.assert_allclose(phi, exact, rtol=2e-3)

    # the output current at the boundary equals the prescribed value
    F = np.asarray(res["J"]["d0"]["face"][0, 0, 0, :, 0])
    js = 2.0 / (2.0 * 1.0)  # jac_x/detJ for fake transverse dims... compute below
    from neutfem_jax.mesh import CartesianMesh as _CM  # noqa: F401
    jac = h / 2.0
    detj = jac  # 1D: detJ = hx/2
    assert F[0] * (jac / detj) == pytest.approx(q, rel=1e-10)
    # MIRROR end carries zero current
    assert abs(F[-1]) < 1e-12


def test_neumann_2d_balance():
    """2D: incoming current on the left edge, MIRROR elsewhere — balance holds."""
    nx = ny = 24
    L, D, siga, q = 48.0, 1.0, 0.08, 0.7
    mesh = CartesianMesh.from_breaks(np.linspace(0, L, nx + 1),
                                     np.linspace(0, L, ny + 1))
    fes = make_fespace(mesh, 0, 0)
    ng = 1
    xs = {
        "D": np.full((ng, *mesh.shape), D),
        "SigR": np.full((ng, *mesh.shape), siga),
        "NSF": np.zeros((ng, *mesh.shape)),
        "Chi": np.ones((ng, *mesh.shape)),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    bcs = BCSpec()
    bcs.set(boundary_attribute(2, 0, False), BCKind.NEUMANN, q)
    bcs.set(boundary_attribute(2, 0, True), BCKind.MIRROR)
    for up in (False, True):
        bcs.set(boundary_attribute(2, 1, up), BCKind.MIRROR)
    ctx = build_context(fes, ng, xs, bcs, dtype=DT)
    opts = SolveOptions(tol_flux=1e-11, inner_tol=1e-13, max_outer=50)
    phi0 = jnp.zeros((ng, *mesh.shape, fes.P), dtype=DT)
    res = fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=False)
    phi = np.asarray(res["phi"][0, 0, :, :, 0])
    h = L / nx
    absorbed = float(np.sum(siga * phi) * h * h)
    assert absorbed == pytest.approx(q * L, rel=1e-8)  # inflow = q * edge length


def test_compat_neumann_value_accepted():
    """The compat surface no longer raises on a nonzero NEUMANN value (reference
    accepts-and-ignores; we accept-and-IMPLEMENT for fixed-source solves)."""
    from neutfem import BCType, BoundaryID, NeutFEM, VerbosityLevel

    n = 8
    s = NeutFEM(0, 1, np.linspace(0, 16.0, n + 1), np.linspace(0, 16.0, n + 1),
                np.array([0.0]))
    s.set_verbosity(VerbosityLevel.SILENT)
    s.set_bc(int(BoundaryID.LEFT_2D), BCType.NEUMANN, 0.5)
    for bid in (BoundaryID.RIGHT_2D, BoundaryID.TOP_2D, BoundaryID.BOTTOM_2D):
        s.set_bc(int(bid), BCType.MIRROR)
    s.get_D()[:] = 1.0
    s.get_SigR()[:] = 0.05
    s.get_NSF()[:] = 0.0
    s.BuildMatrices()
    amp = s.SolveSubcritical()  # runs the fixed-source machinery
    phi = s.get_flux()
    assert np.isfinite(phi).all() and phi.max() > 0  # driven purely by the BC
