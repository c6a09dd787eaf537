"""Regression guards for the internal mode-axis-first array-layout contract.

The solver hot path stores modes FIRST (phi (ng, P, nz, ny, nx), faces
(ng, T, faces...)) so minor dims are always spatial — load-bearing for XLA's
layout assignment and the kernels' line views (see ops/apply.py header).  Public/compat arrays keep the
reference-shaped trailing-mode layout.  These tests pin both sides so a future
change cannot silently regress the convention."""

import numpy as np

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace, zeros_state
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.apply import J_to_public, phi_to_internal, phi_to_public
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import SolveOptions, compute_current, power_iteration

DT = config.real_dtype


def _setup(k=1, m=1):
    mesh = CartesianMesh.from_breaks(
        np.linspace(0, 8, 5), np.linspace(0, 6, 4), np.linspace(0, 4, 3)
    )
    fes = make_fespace(mesh, k, m)
    ng = 2
    xs = {
        "D": np.full((ng, *mesh.shape), 1.2),
        "SigR": np.full((ng, *mesh.shape), 0.05),
        "NSF": np.full((ng, *mesh.shape), 0.06),
        "Chi": np.zeros((ng, *mesh.shape)),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    xs["Chi"][0] = 1.0
    bcs = BCSpec()
    for ax in range(3):
        for up in (False, True):
            bcs.set(boundary_attribute(3, ax, up), BCKind.DIRICHLET)
    return mesh, fes, ng, xs, bcs


def test_context_arrays_are_mode_first():
    mesh, fes, ng, xs, bcs = _setup()
    ctx = build_context(fes, ng, xs, bcs, dtype=DT)
    nz, ny, nx = mesh.shape
    assert ctx["C"].shape == (ng, fes.P, nz, ny, nx)
    assert ctx["precond_inv"].shape == (ng, fes.P, nz, ny, nx)
    assert ctx["w_mode_col"].shape == (fes.P, 1, 1, 1)
    assert ctx["w_mode"].shape == (fes.P,)  # public trailing-mode weight kept


def test_phi_roundtrip_and_public_results():
    mesh, fes, ng, xs, bcs = _setup()
    ctx = build_context(fes, ng, xs, bcs, dtype=DT)
    nz, ny, nx = mesh.shape
    phi_pub = jnp.ones((ng, nz, ny, nx, fes.P), DT)
    phi_int = phi_to_internal(phi_pub)
    assert phi_int.shape == (ng, fes.P, nz, ny, nx)
    np.testing.assert_array_equal(np.asarray(phi_to_public(phi_int)),
                                  np.asarray(phi_pub))

    res = power_iteration(fes, ng, SolveOptions(max_outer=3), ctx, phi_pub, 1.0)
    # results come back in the PUBLIC (reference-shaped) layout
    assert res["phi"].shape == (ng, nz, ny, nx, fes.P)
    for di in fes.dirs:
        entry = res["J"][f"d{di.d}"]
        assert entry["face"].shape == (ng, *di.face_shape, di.T)
        if fes.et.nbub > 0:
            assert entry["bub"].shape == (ng, nz, ny, nx, fes.et.nbub, di.T)


def test_compute_current_is_internal_and_converts():
    mesh, fes, ng, xs, bcs = _setup(k=1, m=0)
    ctx = build_context(fes, ng, xs, bcs, dtype=DT)
    nz, ny, nx = mesh.shape
    phi_int = phi_to_internal(jnp.ones((ng, nz, ny, nx, fes.P), DT))
    J = compute_current(fes, ctx, phi_int)
    for di in fes.dirs:
        assert J[f"d{di.d}"]["face"].shape == (ng, di.T, *di.face_shape)
    Jp = J_to_public(J)
    for di in fes.dirs:
        assert Jp[f"d{di.d}"]["face"].shape == (ng, *di.face_shape, di.T)


def test_zeros_state_is_public_layout():
    mesh, fes, ng, xs, bcs = _setup(k=2, m=2)
    st = zeros_state(fes, ng, DT)
    nz, ny, nx = mesh.shape
    assert st["phi"].shape == (ng, nz, ny, nx, fes.P)
