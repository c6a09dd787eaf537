"""Boundary-condition physics checks: Robin-as-Marshak and Neumann(0)==Mirror."""

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import SolveOptions, power_iteration

DT = config.real_dtype


def _slab(ng=1, n=30, L=60.0):
    mesh = CartesianMesh.from_breaks(np.linspace(0, L, n + 1))
    fes = make_fespace(mesh, 0, 0)
    sh = (ng, *mesh.shape)
    xs = {
        "D": np.full(sh, 1.2),
        "SigR": np.full(sh, 0.03),
        "NSF": np.full(sh, 0.04),
        "Chi": np.ones(sh),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros(sh),
    }
    return mesh, fes, ng, xs


def _solve(mesh, fes, ng, xs, bcs, marshak_d_factor=False, **bckw):
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT,
                        marshak_d_factor=marshak_d_factor)
    opts = SolveOptions(tol_keff=1e-11, tol_flux=1e-9, inner_tol=1e-13)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)
    return float(power_iteration(fes, ng, opts, ctx, phi0, 1.0)["keff"])


def test_robin_reproduces_physical_marshak():
    """ROBIN with alpha*phi + beta*dphi/dn = 0 and beta/alpha = 2*D equals the
    physical (no-D-factor) Marshak vacuum condition phi = 2 (J.n)."""
    mesh, fes, ng, xs = _slab()
    D = xs["D"][0, 0, 0, 0]

    bcs_d = BCSpec()
    bcs_d.set(1, BCKind.MIRROR)
    bcs_d.set(2, BCKind.DIRICHLET)
    k_marshak = _solve(mesh, fes, ng, xs, bcs_d, marshak_d_factor=False)

    bcs_r = BCSpec()
    bcs_r.set(1, BCKind.MIRROR)
    bcs_r.set(2, BCKind.ROBIN)
    # our Robin adds beta/(alpha*D) * G_ff; Marshak adds 2 * G_ff
    bcs_r.robin_alpha = 1.0
    bcs_r.robin_beta = 2.0 * D
    k_robin = _solve(mesh, fes, ng, xs, bcs_r)
    assert k_robin == pytest.approx(k_marshak, abs=1e-10)

    # albedo limits: beta -> inf is reflective (J.n -> 0, higher k);
    # beta -> 0 is a zero-flux boundary (more leakage, lower k)
    bcs_r.robin_beta = 20.0 * D
    k_reflective = _solve(mesh, fes, ng, xs, bcs_r)
    assert k_reflective > k_marshak
    bcs_r.robin_beta = 0.2 * D
    k_open = _solve(mesh, fes, ng, xs, bcs_r)
    assert k_open < k_marshak


def test_neumann_zero_equals_mirror():
    mesh, fes, ng, xs = _slab()
    ks = {}
    for kind in (BCKind.MIRROR, BCKind.NEUMANN):
        bcs = BCSpec()
        bcs.set(1, kind)
        bcs.set(2, BCKind.DIRICHLET)
        ks[kind] = _solve(mesh, fes, ng, xs, bcs)
    assert ks[BCKind.MIRROR] == pytest.approx(ks[BCKind.NEUMANN], abs=1e-13)


def test_mixed_order_rt1_p0_matches_dense_oracle():
    """k != m (RT1-P0) solves through the full stack and reproduces the dense-oracle
    eigenvalue of that discrete system exactly.

    Caveat (shared with the reference, which assembles the identical system): the
    m < k pair is inf-sup stable but INACCURATE — the P0 flux cannot test the RT1
    bubbles' divergences, and bubble condensation softens the face mass, so the
    eigenvalue is thousands of pcm below the m = k schemes.  The API permits it
    (reference parity); use m = k for accuracy."""
    import scipy.linalg
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from oracle import DenseOracle
    from test_power import build_2d_problem, dense_keff

    mesh, _, ng, xs, bcs = build_2d_problem(nx=5, ny=4)
    fes = make_fespace(mesh, 1, 0)
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    k_ref = dense_keff(DenseOracle(fes, ng, xs, bcs), xs, ng)
    opts = SolveOptions(tol_keff=1e-11, tol_flux=1e-9, inner_tol=1e-13)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)
    res = power_iteration(fes, ng, opts, ctx, phi0, 1.0)
    assert float(res["keff"]) == pytest.approx(k_ref, abs=5e-12)
