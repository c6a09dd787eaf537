"""Condensed higher-order Schur matvec vs the legacy bubble chain.

The k >= 1 hot path folds the bubble condensation into per-direction constants
(fespace.DirectionInfo.BXc / Qbub; applied in ops/apply.schur_matvec).  The
dense-oracle tests (test_operators.py) already pin the condensed path against
inv-based ground truth for DIRICHLET/MIRROR; here the folding is asserted
IDENTICAL to the legacy chain on the paths the oracle does not cover
(PERIODIC directions, Marshak/vacuum Robin data, float32) and the constants
are pinned against their definitions.

Reference counterpart: one SchurProduct per CG iteration
(/root/reference/src/solvers.cpp:535-547); the reference materializes every
bubble intermediate through its global sparse matrices.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.apply import phi_to_internal, schur_matvec
from neutfem_jax.ops.context import build_context

DT = config.real_dtype


def _problem(dim, k, m, periodic_axis=None, seed=11):
    rng = np.random.default_rng(seed)

    def breaks(n):
        return np.concatenate([[0.0], np.cumsum(rng.uniform(0.7, 1.5, n))])

    if dim == 2:
        mesh = CartesianMesh.from_breaks(breaks(5), breaks(4))
    else:
        mesh = CartesianMesh.from_breaks(breaks(4), breaks(3), breaks(3))
    fes = make_fespace(mesh, k, m)
    ng = 2
    xs = {
        "D": rng.uniform(0.3, 2.0, (ng, *mesh.shape)),
        "SigR": rng.uniform(0.01, 0.2, (ng, *mesh.shape)),
        "NSF": rng.uniform(0.0, 0.2, (ng, *mesh.shape)),
        "Chi": np.zeros((ng, *mesh.shape)),
        "SigS": rng.uniform(0, 0.05, (ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    xs["Chi"][0] = 1.0

    bcs = BCSpec()
    for ax in range(3):
        if mesh.active(ax):
            for upper in (False, True):
                kind = BCKind.DIRICHLET
                if ax == periodic_axis:
                    kind = BCKind.PERIODIC
                elif ax == 1 and upper:
                    kind = BCKind.MIRROR
                bcs.set(boundary_attribute(mesh.dim, ax, upper), kind)

    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    v = jnp.asarray(
        phi_to_internal(rng.normal(size=(ng, *mesh.shape, fes.P))), dtype=DT
    )
    return fes, ctx, v


CASES = [
    (2, 1, 1, None),
    (2, 2, 2, None),
    (3, 1, 1, None),
    (3, 1, 0, None),
    (3, 2, 1, None),
    (2, 3, 3, None),
    (3, 2, 2, 1),   # PERIODIC y at full order
    (2, 1, 1, 0),   # PERIODIC x
    (3, 1, 1, 2),   # PERIODIC z
]


@pytest.mark.parametrize("dim,k,m,per", CASES)
def test_condensed_matches_legacy(dim, k, m, per, monkeypatch):
    fes, ctx, v = _problem(dim, k, m, periodic_axis=per)

    monkeypatch.setenv("NEUTFEM_CONDENSED", "0")
    legacy = np.asarray(schur_matvec(fes, ctx, v, a_mode="exact"))
    monkeypatch.setenv("NEUTFEM_CONDENSED", "1")
    cond = np.asarray(schur_matvec(fes, ctx, v, a_mode="exact"))

    tol = 1e-12 if DT == jnp.float64 else 2e-5
    scale = np.abs(legacy).max()
    np.testing.assert_allclose(cond, legacy, rtol=0, atol=tol * scale)


def test_condensed_matches_legacy_f32(monkeypatch):
    """The folding must also hold in float32 (the GPU production dtype)."""
    fes, ctx, v = _problem(3, 1, 1)
    ctx32 = {k: jnp.asarray(a, jnp.float32) if hasattr(a, "dtype") else a
             for k, a in ctx.items()}
    v32 = v.astype(jnp.float32)

    monkeypatch.setenv("NEUTFEM_CONDENSED", "0")
    legacy = np.asarray(schur_matvec(fes, ctx32, v32, a_mode="exact"))
    monkeypatch.setenv("NEUTFEM_CONDENSED", "1")
    cond = np.asarray(schur_matvec(fes, ctx32, v32, a_mode="exact"))
    np.testing.assert_allclose(cond, legacy, rtol=0,
                               atol=3e-5 * np.abs(legacy).max())


def test_folded_constants_definitions():
    """BXc and Qbub pinned against their closed forms."""
    mesh = CartesianMesh.from_breaks(
        np.linspace(0, 4, 4), np.linspace(0, 3, 3), np.linspace(0, 2, 3)
    )
    fes = make_fespace(mesh, 2, 1)
    et = fes.et
    assert et.nbub == 2
    for di in fes.dirs:
        BXc = di.BX[:2] - np.einsum("bf,bpt->fpt", et.G, di.BX[2:])
        np.testing.assert_allclose(di.BXc, BXc, rtol=1e-14)
        Q = np.einsum("bpt,bc,cqt,t->pq", di.BX[2:], et.Mbb_inv, di.BX[2:],
                      1.0 / di.m_t)
        np.testing.assert_allclose(di.Qbub, Q, rtol=1e-14)
        # S stays symmetric: Qbub must be symmetric
        np.testing.assert_allclose(Q, Q.T, rtol=1e-13)
