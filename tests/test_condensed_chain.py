"""The higher-order condensed Schur chain (ops/apply.schur_matvec, k >= 1): each
direction's contribution B_d A_d^-1 B_d^T v against the dense oracle, the chain
with the Thomas kernel (interpret mode) against the scan, and the sharded chain
on the 8-device CPU mesh against the unsharded one."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.apply import (
    _face_out,
    _face_rhs,
    phi_to_internal,
    phi_to_public,
    schur_matvec,
    solve_A_dir,
)
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import ctx_group

from oracle import DenseOracle

DT = jnp.float64


def _problem(shape_zyx, k, m, bc_kind=BCKind.DIRICHLET, seed=0, dtype=DT):
    nz, ny, nx = shape_zyx
    rng = np.random.default_rng(seed)
    mesh = CartesianMesh.from_breaks(
        np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, nx))]),
        np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, ny))]),
        np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, nz))]),
    )
    fes = make_fespace(mesh, k, m)
    ng = 2
    xs = {
        "D": rng.uniform(0.3, 2.0, (ng, *mesh.shape)),
        "SigR": rng.uniform(0.01, 0.2, (ng, *mesh.shape)),
        "NSF": rng.uniform(0.0, 0.2, (ng, *mesh.shape)),
        "Chi": np.zeros((ng, *mesh.shape)),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    xs["Chi"][0] = 1.0
    bcs = BCSpec()
    for ax in range(3):
        for upper in (False, True):
            bcs.set(boundary_attribute(3, ax, upper), bc_kind)
    if bc_kind == BCKind.MIRROR:
        bcs.set(boundary_attribute(3, 0, True), BCKind.DIRICHLET)
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=dtype)
    return mesh, fes, ng, xs, bcs, ctx


def _condensed_dir(fes, di, cg, vg):
    """The condensed chain's contribution of one direction (the apply.py branch)."""
    key = f"d{di.d}"
    BXc = jnp.asarray(di.BXc, dtype=vg.dtype)
    F, _ = solve_A_dir(fes, di, cg[f"tri_dinv_{key}"], cg.get(f"tri_l_{key}"),
                       cg[f"mask_{key}"], cg[f"alpha_{key}"], _face_rhs(di, vg, BXc),
                       None, "exact")
    alpha_e = jnp.expand_dims(cg[f"alpha_{key}"], -4)
    Q = jnp.asarray(di.Qbub, dtype=vg.dtype)
    return _face_out(di, F, BXc) + jnp.einsum("...qzyx,pq->...pzyx", vg, Q) / alpha_e


def _oracle_dir(orc, fes, di, g, v_pub):
    """B_d A_d^-1 B_d^T v from the dense oracle (direction d's current DOFs)."""
    o = orc.face_offsets[di.d]
    idx = list(range(o, o + int(np.prod(di.face_shape)) * di.T))
    if fes.et.nbub > 0:
        ob = orc.bub_offsets[di.d]
        idx += list(range(ob, ob + orc.mesh.n_elements * fes.et.nbub * di.T))
    idx = np.asarray(idx)
    Bd = orc.B[:, idx]
    Ad = orc.A[g][np.ix_(idx, idx)]
    return Bd @ np.linalg.solve(Ad, Bd.T @ v_pub.reshape(-1))


@pytest.mark.parametrize("k,bc", [
    (1, BCKind.DIRICHLET),
    (1, BCKind.MIRROR),
    (2, BCKind.DIRICHLET),
])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_condensed_dir_matches_dense_oracle(k, bc, axis):
    mesh, fes, ng, xs, bcs, ctx = _problem((2, 3, 4), k, k, bc_kind=bc)
    orc = DenseOracle(fes, ng, xs, bcs)
    rng = np.random.default_rng(5)
    v_pub = rng.normal(size=(ng, *mesh.shape, fes.P))
    v = phi_to_internal(jnp.asarray(v_pub, DT))
    di = [d for d in fes.dirs if d.axis == axis][0]
    for g in range(ng):
        got = phi_to_public(_condensed_dir(fes, di, ctx_group(ctx, g), v[g][None]))[0]
        want = _oracle_dir(orc, fes, di, g, v_pub[g])
        np.testing.assert_allclose(np.asarray(got).reshape(-1), want,
                                   rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_condensed_m_lt_k_matches_dense_oracle():
    """RT1-P0 (flux order below the current order): the whole Schur operator."""
    mesh, fes, ng, xs, bcs, ctx = _problem((2, 3, 4), 1, 0)
    orc = DenseOracle(fes, ng, xs, bcs)
    v_pub = np.random.default_rng(2).normal(size=(ng, *mesh.shape, fes.P))
    got = phi_to_public(schur_matvec(fes, ctx, phi_to_internal(jnp.asarray(v_pub)),
                                     "exact"))
    for g in range(ng):
        want = orc.schur(g) @ v_pub[g].reshape(-1)
        np.testing.assert_allclose(np.asarray(got[g]).reshape(-1), want,
                                   rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_condensed_kernel_path_interpret(monkeypatch):
    """RT2 through the production dispatch with the Thomas kernel (interpret
    mode; the transverse-mode axis multiplies the line count) equals the scan."""
    mesh, fes, ng, xs, bcs, ctx = _problem((4, 8, 16), 2, 2, dtype=jnp.float32)
    v = phi_to_internal(jnp.asarray(
        np.random.default_rng(4).normal(size=(ng, *mesh.shape, fes.P)), jnp.float32))
    want = schur_matvec(fes, ctx, v, "exact")
    monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    got = schur_matvec(fes, ctx, v, "exact")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4 * float(jnp.abs(want).max()))


def test_block_precond_storage_tiers():
    """The equilibrated P x P block-Jacobi inverse of a float32 context is
    stored fp8 E-form by default, bf16 with NEUTFEM_BLKFP8=0, and as-is in
    float64."""
    mesh = CartesianMesh.from_breaks(
        np.linspace(0, 8, 9), np.linspace(0, 8, 9), np.linspace(0, 8, 9)
    )
    fes = make_fespace(mesh, 1, 1)
    ng = 1
    sp = mesh.shape
    xs = {
        "D": np.full((ng, *sp), 1.2), "SigR": np.full((ng, *sp), 0.1),
        "NSF": np.zeros((ng, *sp)), "Chi": np.ones((ng, *sp)),
        "SigS": np.zeros((ng, ng, *sp)), "SRC": np.zeros((ng, *sp)),
    }
    bcs = BCSpec()
    for ax in range(3):
        for up in (False, True):
            bcs.set(boundary_attribute(3, ax, up), BCKind.DIRICHLET)
    ctx = build_context(fes, ng, xs, bcs, dtype=jnp.float32)
    assert ctx["precond_blk_dev"].dtype == jnp.float8_e4m3fn
    assert "precond_blk_inv" not in ctx
    old = os.environ.get("NEUTFEM_BLKFP8")
    os.environ["NEUTFEM_BLKFP8"] = "0"
    try:
        ctx_bf = build_context(fes, ng, xs, bcs, dtype=jnp.float32)
    finally:
        if old is None:
            os.environ.pop("NEUTFEM_BLKFP8")
        else:
            os.environ["NEUTFEM_BLKFP8"] = old
    assert ctx_bf["precond_blk_inv"].dtype == jnp.bfloat16
    # the fp8 E-form must reconstruct the bf16 inverse to e4m3 resolution
    eyeP = np.eye(fes.P).reshape(1, fes.P, fes.P, 1, 1, 1)
    rec = np.asarray(ctx["precond_blk_dev"].astype(jnp.float32)) + eyeP
    ref = np.asarray(ctx_bf["precond_blk_inv"].astype(jnp.float32))
    assert np.abs(rec - ref).max() / np.abs(ref).max() < 0.07, "fp8 E-form off"
    ctx64 = build_context(fes, ng, xs, bcs, dtype=jnp.float64)
    assert ctx64["precond_blk_inv"].dtype == jnp.float64


def _sharded_matvec(fes, ctx, v, cut):
    from neutfem_jax.parallel import device_mesh, shard_context
    from neutfem_jax.shardctx import sharding_scope

    dmesh = device_mesh(8)
    amap = {cut: dmesh.axis_names[0]}
    ctx_sh = shard_context(ctx, dmesh, fes, grid_axis=cut)
    f = jax.jit(lambda c, x: schur_matvec(fes, c, x, "exact"))
    with sharding_scope(dmesh, amap):
        return f(ctx_sh, v), ctx_sh


@pytest.mark.parametrize("cut", [0, 1, 2])
def test_condensed_sharded_matches_unsharded(cut):
    """The condensed chain under a z, y or x cut of the 8-device mesh (the cut
    direction on the partitioned solve, the others shard-local) equals the
    unsharded chain."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    mesh, fes, ng, xs, bcs, ctx = _problem((16, 16, 16), 1, 1)
    v = phi_to_internal(jnp.asarray(
        np.random.default_rng(6).normal(size=(ng, *mesh.shape, fes.P)), DT))
    want = schur_matvec(fes, ctx, v, "exact")
    got, _ = _sharded_matvec(fes, ctx, v, cut)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-9, atol=1e-9 * float(jnp.abs(want).max()))


def test_shard_context_drops_dead_operands():
    """shard_context attaches the partitioned-solve bundle to the cut direction
    and keeps no fused-kernel operand of it (RT0), and the higher-order context
    carries no staged kernel operand at all."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from neutfem_jax.parallel import device_mesh, shard_context

    _, fes0, _, _, _, ctx0 = _problem((16, 8, 8), 0, 0)
    sh0 = shard_context(ctx0, device_mesh(8), fes0, grid_axis=0)
    assert "tri_dinvm_d2" not in sh0 and "tri_dinvm_d0" in sh0  # z is d2
    assert any(k.startswith("tri_part_") and k.endswith("_d2") for k in sh0)
    _, fes1, _, _, _, ctx1 = _problem((16, 8, 8), 1, 1)
    assert not any(k.startswith("tri_dinvm_") for k in ctx1)
    sh1 = shard_context(ctx1, device_mesh(8), fes1, grid_axis=0)
    assert any(k.startswith("tri_part_") and k.endswith("_d2") for k in sh1)


def test_condensed_sharded_batched_flux():
    """The all-groups layout (ng, P, ...) — sweep="jacobi" — under a z cut, one
    group at a time against the per-group unsharded chain."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    mesh, fes, ng, xs, bcs, ctx = _problem((16, 8, 8), 1, 1)
    v = phi_to_internal(jnp.asarray(
        np.random.default_rng(8).normal(size=(ng, *mesh.shape, fes.P)), DT))
    got, _ = _sharded_matvec(fes, ctx, v, 0)
    for g in range(ng):
        want = schur_matvec(fes, ctx_group(ctx, g), v[g], "exact")
        np.testing.assert_allclose(np.asarray(got[g]), np.asarray(want),
                                   rtol=1e-9, atol=1e-9 * float(jnp.abs(want).max()))


def test_condensed_under_vmap(monkeypatch):
    """The dense Schur of the direct solver applies the condensed chain under
    vmap (fused=False keeps the kernels out even when they are enabled) and
    must equal the oracle's Schur complement."""
    from neutfem_jax.ops.direct import dense_schur_group

    mesh, fes, ng, xs, bcs, ctx = _problem((2, 3, 4), 1, 1)
    orc = DenseOracle(fes, ng, xs, bcs)
    monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    S = np.asarray(dense_schur_group(fes, ctx_group(ctx, 0), "exact"))
    # internal mode-first ordering -> oracle (cell-major, mode-minor) ordering
    n = mesh.n_elements
    perm = (np.arange(fes.P)[None, :] * n + np.arange(n)[:, None]).reshape(-1)
    want = orc.schur(0)
    np.testing.assert_allclose(S[np.ix_(perm, perm)], want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
