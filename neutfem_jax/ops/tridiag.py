"""Batched symmetric tridiagonal solves.

The reference solves its per-direction RT mass systems implicitly inside Eigen's sparse
LU (``/root/reference/src/solvers.cpp:157-167``), re-factorizing every group solve.  Here
the per-direction A blocks are *exactly* tridiagonal along mesh lines (after bubble
condensation), so we:

* factorize once per (group, direction) with a sequential ``lax.scan`` (cheap, amortized
  over the whole power iteration), and
* apply forward/backward substitution with ``lax.associative_scan`` — both substitutions
  are first-order affine recurrences, so they run in O(log n) depth, fully parallel over
  the (groups x lines x transverse-modes) batch.  On the GPU the Thomas kernel of
  ``ops/pallas_tridiag.py`` replaces the scans where ``use_thomas`` accepts the
  shape.  Both stand in for the unused serial ``ThomasSolver`` of the reference
  (solvers.cpp:940-989).

All functions operate along a caller-chosen axis; every other axis is batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["tridiag_factor", "tridiag_solve", "affine_scan"]


def tridiag_factor(diag, off, axis: int = -1):
    """LDL^T factorization of SPD tridiagonal systems along `axis`.

    diag: (..., n, ...) main diagonal; off: (..., n-1, ...) sub/super diagonal.
    Returns (dinv, l): 1/pivots (..., n, ...) and multipliers (..., n-1, ...).

    Recurrence: d_0 = a_0;  l_i = b_i / d_i;  d_{i+1} = a_{i+1} - b_i * l_i.
    """
    a = jnp.moveaxis(diag, axis, 0)
    b = jnp.moveaxis(off, axis, 0)

    def step(d_prev, ab):
        a_i, b_prev = ab
        l = b_prev / d_prev
        d = a_i - b_prev * l
        return d, (d, l)

    d0 = a[0]
    _, (d_rest, l) = lax.scan(step, d0, (a[1:], b))
    d = jnp.concatenate([d0[None], d_rest], axis=0)
    return jnp.moveaxis(1.0 / d, 0, axis), jnp.moveaxis(l, 0, axis)


def affine_scan(a, b, axis: int, reverse: bool = False):
    """Solve z_i = a_i * z_{i-1} + b_i (inclusive, z_{-1}=0) along `axis`.

    With reverse=True solves z_i = a_i * z_{i+1} + b_i (z_{n}=0).
    `a` and `b` must have the same shape.  O(log n) depth via associative_scan.
    """
    if reverse:
        a = jnp.flip(a, axis)
        b = jnp.flip(b, axis)

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_r * a_l, a_r * b_l + b_r

    _, z = lax.associative_scan(combine, (a, b), axis=axis % a.ndim)
    if reverse:
        z = jnp.flip(z, axis)
    return z


def _scan_solve(rhs, dinv_b, lb, axis: int):
    """Portable path: forward/backward affine recurrences via associative_scan.
    dinv_b / lb must already have rhs-compatible shapes."""
    zero = jnp.zeros_like(lax.slice_in_dim(rhs, 0, 1, axis=axis))
    # a for forward: [0, -l_0, ..., -l_{n-2}]
    a_fwd = jnp.concatenate([zero, -lb], axis=axis)
    z = affine_scan(a_fwd, rhs, axis=axis)
    w = z * dinv_b
    # a for backward: [-l_0, ..., -l_{n-2}, 0]
    a_bwd = jnp.concatenate([-lb, zero], axis=axis)
    return affine_scan(a_bwd, w, axis=axis, reverse=True)


#: longest solve axis the Thomas kernel takes.  On the H100 the kernel's 2n
#: dependent steps beat the scans' O(log n) passes on lines of 20-137 entries
#: and lost on 273- and 545-entry lines, whatever the line count (PERF.md).
MAX_THOMAS_N = 256


def use_thomas(shape, axis: int) -> bool:
    """Shape rule for the Thomas kernel: a solve axis of 4 to MAX_THOMAS_N
    entries (shorter axes are degenerate lines, longer ones go to the scan)."""
    return 4 <= shape[axis] <= MAX_THOMAS_N


def _local_solve(rhs, dinv_b, lb, axis: int, kernel: bool = True):
    """Single-device solve: the Thomas kernel where ``kernel_mode`` and
    ``use_thomas`` allow it, else the scan."""
    from .pallas_tridiag import kernel_mode, thomas_solve

    mode = kernel_mode() if kernel else None
    if mode is not None and use_thomas(rhs.shape, axis):
        return thomas_solve(rhs, dinv_b, lb, axis, interpret=mode == "interpret")
    return _scan_solve(rhs, dinv_b, lb, axis)


def tridiag_solve(rhs, dinv, l, axis: int, shard=None, kernel: bool = True):
    """Solve T x = rhs with precomputed (dinv, l) from tridiag_factor, along `axis`.

    rhs may have extra trailing/leading batch axes: dinv/l are broadcast against it.
    Forward:  z_i = r_i - l_{i-1} z_{i-1}
    Diagonal: w = z * dinv
    Backward: x_i = w_i - l_i x_{i+1}

    On the GPU, shapes that ``use_thomas`` accepts go to the Thomas kernel (one
    read and one write per operand instead of the scans' ~2 log2(n) passes); the
    associative_scan path serves the CPU, small problems, ``kernel=False`` (callers
    under ``vmap``) and NEUTFEM_PALLAS=0.

    shard: optional ``(mesh, {array_dim: mesh_axis_name})`` from the caller when the
    operands are sharded over a device mesh along batch dims (never along `axis`):
    the solve is wrapped in ``jax.shard_map`` so each shard solves its complete
    local lines (with the kernel where it applies) instead of GSPMD all-gathering
    a pallas_call.
    """
    axis = axis % rhs.ndim
    n = rhs.shape[axis]
    dinv_b = jnp.broadcast_to(dinv, rhs.shape)
    lb = jnp.broadcast_to(l, rhs.shape[:axis] + (n - 1,) + rhs.shape[axis + 1:])

    if shard is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        mesh, dim_names = shard
        assert axis not in dim_names, "cannot shard_map along the solve axis"
        spec = P(*[dim_names.get(d) for d in range(rhs.ndim)])
        return shard_map(
            lambda r, d, lo: _local_solve(r, d, lo, axis, kernel),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            # pallas_call's ShapeDtypeStruct outputs carry no vma annotation
            check_vma=False,
        )(rhs, dinv_b, lb)

    return _local_solve(rhs, dinv_b, lb, axis, kernel)
