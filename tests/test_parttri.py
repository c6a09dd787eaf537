"""Partitioned cut-axis tridiagonal solve (ops/parttri.py): exactness vs the
global solve, pinned-face handling, decline paths, and collective footprint."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from neutfem_jax.ops.parttri import build_partitioned, tridiag_solve_partitioned
from neutfem_jax.ops.tridiag import tridiag_factor, _scan_solve

P_DEV = 8


def _mesh():
    return Mesh(np.array(jax.devices()[:P_DEV]), ("s",))


def _system(rng, batch, m, fax):
    """Random SPD tridiagonal batch with the face axis at ``fax``."""
    a = rng.uniform(2.5, 4.0, size=batch[:fax] + (m,) + batch[fax:])
    b = rng.uniform(-1.0, -0.2, size=batch[:fax] + (m - 1,) + batch[fax:])
    return a, b


def _global_solve(rhs, dinv, l, axis):
    dinv_e = jnp.expand_dims(dinv, -4)
    l_e = jnp.expand_dims(l, -4)
    n = rhs.shape[axis]
    dinv_b = jnp.broadcast_to(dinv_e, rhs.shape)
    l_b = jnp.broadcast_to(l_e, rhs.shape[:axis] + (n - 1,) + rhs.shape[axis + 1:])
    return _scan_solve(rhs, dinv_b, l_b, axis)


@pytest.mark.parametrize("pinned", [False, True])
def test_partitioned_matches_global(pinned):
    rng = np.random.default_rng(7)
    m = 2 * P_DEV + 1                    # 17 faces = 16 body (s=2) + seam
    a, b = _system(rng, (2, 5, 8), m, fax=1)   # (ng, m, ly, lx)
    if pinned:
        # pin a face AT a shard boundary and one interior face, the way the
        # context does (diag 1, couplings 0) — MIRROR/Dirichlet-masked faces
        for f in (P_DEV, 3):
            a[:, f] = 1.0
            b[:, f - 1] = 0.0
            if f < m - 1:
                b[:, f] = 0.0
    dinv, l = tridiag_factor(jnp.asarray(a), jnp.asarray(b), axis=1)

    part = build_partitioned(np.asarray(dinv), np.asarray(l), 1, P_DEV)
    assert part is not None
    assert part["minv"].shape[-2:] == (2 * P_DEV, 2 * P_DEV)

    rhs = jnp.asarray(rng.normal(size=(2, 3, m, 5, 8)))  # extra T axis
    x_ref = _global_solve(rhs, dinv, l, axis=2)
    with _mesh() as mesh:
        x = tridiag_solve_partitioned(rhs, part, 2, mesh, "s")
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               rtol=5e-11, atol=5e-11)


def test_partitioned_group_batched_layout():
    """Leading-group batched layout (jacobi sweep): factors carry ng, rhs
    carries (ng, T, ...) — the rank alignment must pad BEFORE the spatial
    dims, not in front."""
    rng = np.random.default_rng(3)
    m = 3 * P_DEV + 1                    # s=3
    a, b = _system(rng, (2, 4, 8), m, fax=1)
    dinv, l = tridiag_factor(jnp.asarray(a), jnp.asarray(b), axis=1)
    part = build_partitioned(np.asarray(dinv), np.asarray(l), 1, P_DEV)
    rhs = jnp.asarray(rng.normal(size=(2, 2, m, 4, 8)))
    x_ref = _global_solve(rhs, dinv, l, axis=2)
    with _mesh() as mesh:
        x = tridiag_solve_partitioned(rhs, part, 2, mesh, "s")
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               rtol=5e-11, atol=5e-11)


def test_partitioned_p1_degenerate_mesh():
    """p = 1 (the real-chip 1-device-mesh A/B path): a single segment, the
    output window padded by the trailing zero row — must still be exact."""
    rng = np.random.default_rng(11)
    m = 13                               # n = 12 cells, one segment
    a, b = _system(rng, (2, 4, 8), m, fax=1)
    dinv, l = tridiag_factor(jnp.asarray(a), jnp.asarray(b), axis=1)
    part = build_partitioned(np.asarray(dinv), np.asarray(l), 1, 1)
    assert part is not None
    rhs = jnp.asarray(rng.normal(size=(2, 1, m, 4, 8)))
    x_ref = _global_solve(rhs, dinv, l, axis=2)
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("s",))
    with mesh1:
        x = tridiag_solve_partitioned(rhs, part, 2, mesh1, "s")
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               rtol=5e-11, atol=5e-11)


def test_partitioned_2d_device_mesh():
    """2D device mesh (round 5): the cut axis partitions over ITS mesh axis
    while the other mesh axis shards a line dim as a pure batch — every spec
    (rhs/constants/seam/minv line dims) must carry the other axis name."""
    rng = np.random.default_rng(17)
    pz, py = 2, 4
    m = 3 * pz + 1                       # n = 6, s = 3 along the cut
    a, b = _system(rng, (2, 8, 16), m, fax=1)   # (ng, m, ly=8, lx=16); ly % py == 0
    dinv, l = tridiag_factor(jnp.asarray(a), jnp.asarray(b), axis=1)
    part = build_partitioned(np.asarray(dinv), np.asarray(l), 1, pz)
    assert part is not None
    rhs = jnp.asarray(rng.normal(size=(2, 1, m, 8, 16)))
    x_ref = _global_solve(rhs, dinv, l, axis=2)
    mesh2 = Mesh(np.array(jax.devices()[:pz * py]).reshape(pz, py), ("s", "t"))
    with mesh2:
        x = tridiag_solve_partitioned(rhs, part, 2, mesh2, "s",
                                      other={3: "t"})
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               rtol=5e-11, atol=5e-11)


def test_build_declines_on_indivisible_or_thin():
    rng = np.random.default_rng(1)
    a, b = _system(rng, (1, 4, 4), 14, fax=1)   # body 13 % 8 != 0
    dinv, l = tridiag_factor(jnp.asarray(a), jnp.asarray(b), axis=1)
    assert build_partitioned(np.asarray(dinv), np.asarray(l), 1, P_DEV) is None
    a, b = _system(rng, (1, 4, 4), P_DEV + 1, fax=1)  # s=1 < 2
    dinv, l = tridiag_factor(jnp.asarray(a), jnp.asarray(b), axis=1)
    assert build_partitioned(np.asarray(dinv), np.asarray(l), 1, P_DEV) is None


def test_pipeline_depth2_collectives_bounded():
    """Regression pin for the round-5 reshard fix, measured where it matters:
    the FULL sharded power iteration's compiled HLO.

    The first parttri implementation did the ceil<->body-even face-layout
    conversion with jnp-level slice/concat, which GSPMD lowered as a FULL
    all-gather of the solution array per application (~31 of 38.4 MB/inner at
    3.5M z8, counted from the compiled HLO); an isolated-solve harness could NOT see
    this because a body-aligned device_put hides the reshard.  Pins:

    1. no single depth-2 (per-inner) all-gather moves more than the
       interface/seam gathers (O(p) planes) — a full-array gather is ~nz/p x
       bigger and trips the bound;
    2. the partitioned path's total depth-2 bytes stay well under the
       associative-scan path's (NEUTFEM_PARTTRI=0) on the same problem.
    """
    import os

    from benchmarks.ici_accounting import collective_inventory
    from test_parallel import _problem_3d
    from neutfem_jax.parallel import (device_mesh, shard_context, shard_state,
                                      sharded_power_iteration)
    from neutfem_jax.power import SolveOptions

    if len(jax.devices()) < P_DEV:
        pytest.skip("needs the 8-device virtual mesh")

    nz, ny, nx = 32, 12, 8
    fes, ng, ctx, phi0 = _problem_3d(nz=nz, ny=ny, nx=nx)
    opts = SolveOptions(max_outer=30)
    dmesh = device_mesh(P_DEV)

    def depth2(ctx_sh):
        run, _ = sharded_power_iteration(fes, ng, opts, dmesh, grid_axis=0)
        phi_sh = shard_state(phi0, dmesh, grid_axis=0)
        txt = run.lower(ctx_sh, phi_sh, 1.0).compile().as_text()
        return [c for c in collective_inventory(txt) if c["depth"] >= 2]

    inv_part = depth2(shard_context(ctx, dmesh, fes, grid_axis=0))
    os.environ["NEUTFEM_PARTTRI"] = "0"
    try:
        inv_scan = depth2(shard_context(ctx, dmesh, fes, grid_axis=0))
    finally:
        del os.environ["NEUTFEM_PARTTRI"]

    plane = ny * nx * np.dtype(np.asarray(phi0).dtype).itemsize
    gathers = [c for c in inv_part if c["op"] == "all-gather"]
    assert gathers, "expected interface/seam all-gathers in the inner loop"
    # full-array gather would be ~nz*plane = 32 planes; interface/seam are
    # p or 2p rows of one plane each
    assert max(c["bytes"] for c in gathers) <= 2 * P_DEV * plane, gathers

    part_bytes = sum(c["bytes"] for c in inv_part)
    scan_bytes = sum(c["bytes"] for c in inv_scan)
    assert part_bytes < scan_bytes / 2, (part_bytes, scan_bytes)
