"""Fused RT0 Schur direction kernel (ops/pallas_fused.py) vs the unfused ops,
interpret mode on CPU.  The fused kernel computes acc + B_d A_d^{-1} B_d^T v in
one pass along each line; the unfused reference path is apply_BT -> solve_A ->
apply_B."""

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import make_fespace
from neutfem_jax.mesh import CartesianMesh, boundary_attribute
from neutfem_jax.ops.apply import fused_fits, phi_to_internal, schur_matvec
from neutfem_jax.ops.context import build_context
from neutfem_jax.ops.pallas_fused import fused_schur_dir

DT = jnp.float32  # the solver's GPU working precision


def _problem(shape_zyx, bc_kind=BCKind.DIRICHLET, seed=0, k=0, m=0):
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
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    return mesh, fes, ng, ctx


def _unfused_dir(fes, ctx, di, v):
    from neutfem_jax.ops.apply import apply_B_dir, apply_BT_dir, solve_A_dir

    key = f"d{di.d}"
    rF, rW = apply_BT_dir(fes, di, v)
    F, W = solve_A_dir(fes, di, ctx[f"tri_dinv_{key}"], ctx.get(f"tri_l_{key}"),
                       ctx[f"mask_{key}"], ctx[f"alpha_{key}"], rF, rW, "exact")
    return apply_B_dir(fes, di, F, W)


def _fused_dir(ctx, di, acc, v):
    key = f"d{di.d}"
    dm = jnp.expand_dims(ctx[f"tri_dinvm_{key}"], -4)
    lf = jnp.expand_dims(ctx[f"tri_l_{key}"], -4)
    return fused_schur_dir(acc, v, dm, lf, di.axis - 3, float(di.BX[0, 0, 0]),
                           float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0]),
                           interpret=True)


@pytest.mark.parametrize("bc", [BCKind.DIRICHLET, BCKind.MIRROR])
def test_fused_matches_unfused_all_directions(bc):
    mesh, fes, ng, ctx = _problem((6, 9, 11), bc_kind=bc)
    rng = np.random.default_rng(3)
    v = phi_to_internal(
        jnp.asarray(rng.normal(size=(ng, *mesh.shape, fes.P)), DT)
    )

    # unfused reference (CPU: no kernels, so schur_matvec takes it)
    want = schur_matvec(fes, ctx, v, a_mode="exact")

    # fused, direction by direction in interpret mode
    out = ctx["C"] * v
    for di in fes.dirs:
        out = _fused_dir(ctx, di, out, v)

    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("d", [0, 1, 2])
def test_fused_pre_staged_matches_broadcast_kernel(d):
    """The per-group layout the CG uses (ctx_group slices, (1, nz, ny, nx)
    flux) must give the same contribution as the all-groups layout (the kernel
    sees different leading line counts)."""
    from neutfem_jax.power import ctx_group

    mesh, fes, ng, ctx = _problem((5, 7, 9))
    di = [x for x in fes.dirs if x.d == d][0]
    rng = np.random.default_rng(5)
    v_all = jnp.asarray(rng.normal(size=(ng, 1, *mesh.shape)), DT)
    acc_all = jnp.asarray(rng.normal(size=(ng, 1, *mesh.shape)), DT)
    batched = _fused_dir(ctx, di, acc_all, v_all)
    for g in range(ng):
        ctxg = ctx_group(ctx, g)
        res = _fused_dir(ctxg, di, acc_all[g], v_all[g])
        np.testing.assert_allclose(np.asarray(res), np.asarray(batched[g]),
                                   rtol=3e-5, atol=3e-5)
        want = acc_all[g] + _unfused_dir(fes, ctxg, di, v_all[g])
        np.testing.assert_allclose(np.asarray(res), np.asarray(want),
                                   rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("order", [(0, 0), (1, 1)])
def test_eqfold_matches_classic_wrapper(order, monkeypatch):
    """The production dispatch with the kernels (interpret mode: the fused
    direction for RT0, the Thomas kernel inside the condensed chain for RT1)
    equals the plain XLA matvec, on a shape the kernels accept in every
    direction."""
    mesh, fes, ng, ctx = _problem((8, 64, 64) if order == (0, 0) else (8, 16, 32),
                                  k=order[0], m=order[1])
    if order == (0, 0):
        for ax in (-3, -2, -1):
            assert fused_fits((1, 1, *mesh.shape), ax)
    rng = np.random.default_rng(11)
    v = phi_to_internal(jnp.asarray(rng.normal(size=(ng, *mesh.shape, fes.P)), DT))
    want = schur_matvec(fes, ctx, v, a_mode="exact")
    monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    got = schur_matvec(fes, ctx, v, a_mode="exact")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=3e-5 * float(jnp.abs(want).max()))
    # fused=False (callers under vmap) keeps every kernel out
    np.testing.assert_allclose(
        np.asarray(schur_matvec(fes, ctx, v, a_mode="exact", fused=False)),
        np.asarray(want), rtol=1e-6, atol=1e-6 * float(jnp.abs(want).max()))


def test_fused_declines_small_shapes(monkeypatch):
    """Outside the shape rule (solve axes shorter than 4) the dispatch takes
    the unfused chain (the kernel itself would still be correct there)."""
    mesh, fes, ng, ctx = _problem((3, 3, 3))
    v = jnp.asarray(np.random.default_rng(2).normal(size=(ng, 1, *mesh.shape)), DT)
    for ax in (-3, -2, -1):
        assert not fused_fits(v.shape, ax)
    want = schur_matvec(fes, ctx, v, a_mode="exact")
    monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    got = schur_matvec(fes, ctx, v, a_mode="exact")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    out = ctx["C"] * v
    for di in fes.dirs:
        out = _fused_dir(ctx, di, out, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_fused_sharded_matches_unfused():
    """The shard_map-wrapped fused kernel (direction orthogonal to the cut) must
    equal the unfused schur contribution — virtual 8-device mesh, interpret mode."""
    import jax
    from neutfem_jax.ops.apply import _fused_sharded
    from neutfem_jax.parallel import device_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    # ny = 64 divides the 8-device mesh; cut axis = y (spatial axis 1); the
    # PER-SHARD local shapes (2 groups x 32 x 8 x 64) pass the shape rule for
    # x and z
    mesh, fes, ng, ctx = _problem((32, 64, 64))
    rng = np.random.default_rng(7)
    v = phi_to_internal(jnp.asarray(rng.normal(size=(ng, *mesh.shape, fes.P)), DT))
    want = schur_matvec(fes, ctx, v, a_mode="exact")

    dmesh = device_mesh(8)
    amap = {1: dmesh.axis_names[0]}
    out = ctx["C"] * v
    n_sharded = 0
    for di in fes.dirs:
        key = f"d{di.d}"
        dm = jnp.expand_dims(ctx[f"tri_dinvm_{key}"], -4)
        lf = jnp.expand_dims(ctx[f"tri_l_{key}"], -4)
        res = _fused_sharded((dmesh, amap), out, v,
                             dm, lf, di.axis - 3,
                             float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]),
                             1.0 / float(di.m_t[0]), interpret=True)
        if di.axis == 1:
            assert res is None  # solve axis on the cut: must decline
        if res is None:
            out = out + _unfused_dir(fes, ctx, di, v)
        else:
            n_sharded += 1
            out = res
    assert n_sharded == 2  # x and z went through the sharded fused kernel
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("pin_kind", [BCKind.MIRROR, BCKind.NEUMANN])
def test_pinned_face_factors_are_zero(k, pin_kind):
    """The invariant the fused kernel relies on (no rhs mask plane): wherever
    the context pins a face (mask == 0), the factored off-diagonal OUT of that
    face (l_f, f < n) and its dinv*mask entry are EXACTLY zero, so an
    un-masked forward-sweep value at a pinned face can never reach a valid
    output (pallas_fused.py module docstring).  context.py guarantees it by
    zeroing offd BEFORE the LDL^T factorization; this test pins that ordering,
    for every order, so a future BC kind cannot silently break the kernel
    math."""
    mesh = CartesianMesh.from_breaks(
        np.linspace(0.0, 8.0, 9), np.linspace(0.0, 7.0, 8),
        np.linspace(0.0, 6.0, 7),
    )
    fes = make_fespace(mesh, k, k)
    ng = 2
    rng = np.random.default_rng(7)
    xs = {
        "D": rng.uniform(0.3, 2.0, (ng, *mesh.shape)),
        "SigR": rng.uniform(0.01, 0.2, (ng, *mesh.shape)),
        "NSF": np.zeros((ng, *mesh.shape)),
        "Chi": np.ones((ng, *mesh.shape)),
        "SigS": np.zeros((ng, ng, *mesh.shape)),
        "SRC": np.zeros((ng, *mesh.shape)),
    }
    # mix pinning and non-pinning kinds so interior entries stay nonzero
    bcs = BCSpec()
    for ax in range(3):
        bcs.set(boundary_attribute(3, ax, False), pin_kind)
        bcs.set(boundary_attribute(3, ax, True),
                BCKind.DIRICHLET if ax != 1 else pin_kind)
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)

    pinned_dirs = 0
    for di in fes.dirs:
        key = f"d{di.d}"
        mask = np.asarray(ctx[f"mask_{key}"])
        dinvm = np.asarray(ctx[f"tri_dinv_{key}"]) * mask[None]
        if k == 0:
            np.testing.assert_array_equal(np.asarray(ctx[f"tri_dinvm_{key}"]), dinvm)
        l = np.asarray(ctx[f"tri_l_{key}"])
        fax = di.axis  # 3D mesh: mask is (nz, ny, nx) with n+1 along fax
        n = mask.shape[fax] - 1  # faces 0..n
        pin = (np.moveaxis(mask, fax, 0) == 0.0)
        if not pin.any():
            continue
        pinned_dirs += 1
        # dinvm carries a leading group axis: move ITS face axis forward
        dm_f = np.moveaxis(dinvm, fax + 1, 0)
        l_f = np.moveaxis(l, fax + 1, 0)
        for f in range(n + 1):
            sel = pin[f]
            if not sel.any():
                continue
            assert (dm_f[f][..., sel] == 0.0).all(), (key, f, "dinvm")
            if f < n:
                assert (l_f[f][..., sel] == 0.0).all(), (key, f, "l_f")
    assert pinned_dirs == 3  # every direction had at least one pinned face
    # the staged operand exists only where the fused kernel can read it
    assert ("tri_dinvm_d0" in ctx) == (k == 0)


def test_fused_x_declines_long_axis_fault_regime(monkeypatch):
    """Fine 2D core meshes put a long solve axis on x and y (545 faces per line
    at KOEBERG 32x32).  The production dispatch takes the fused kernel on the
    short axis and the unfused chain on the long one, and must match the
    unfused reference; the kernel itself is still right on the long axis."""
    ny, nx = 40, 600
    rng = np.random.default_rng(7)
    mesh = CartesianMesh.from_breaks(
        np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, nx))]),
        np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, ny))]),
    )
    fes = make_fespace(mesh, 0, 0)
    ng = 1
    xs = {
        "D": rng.uniform(0.3, 2.0, (ng, *mesh.shape)),
        "SigR": rng.uniform(0.01, 0.2, (ng, *mesh.shape)),
        "NSF": np.zeros((ng, *mesh.shape)), "Chi": np.ones((ng, *mesh.shape)),
        "SigS": np.zeros((ng, ng, *mesh.shape)), "SRC": np.zeros((ng, *mesh.shape)),
    }
    bcs = BCSpec()
    for ax in (0, 1):
        for upper in (False, True):
            bcs.set(boundary_attribute(2, ax, upper), BCKind.DIRICHLET)
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    v = phi_to_internal(jnp.asarray(rng.normal(size=(ng, *mesh.shape, fes.P)), DT))

    assert fused_fits(v.shape, -2)       # y: 600 lines of 41 faces
    assert not fused_fits(v.shape, -1)   # x: 40 lines of 601 faces, too long
    want = schur_matvec(fes, ctx, v, a_mode="exact", fused=False)
    monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    got = schur_matvec(fes, ctx, v, a_mode="exact")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=3e-5)
    # the long x axis through the kernel itself
    di_x = [d for d in fes.dirs if d.axis == 2][0]
    acc = jnp.zeros_like(v)
    got_x = _fused_dir(ctx, di_x, acc, v)
    np.testing.assert_allclose(np.asarray(got_x),
                               np.asarray(_unfused_dir(fes, ctx, di_x, v)),
                               rtol=3e-5, atol=3e-5)
