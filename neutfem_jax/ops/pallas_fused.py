"""Fused RT0 Schur direction: acc + B_d A_d^{-1} B_d^T v in one Pallas (Triton
route) kernel.

The unfused chain (``apply.apply_BT_dir`` -> ``solve_A_dir`` -> ``apply_B_dir``)
writes the face rhs rF and the face solution F to device memory and reads them
back.  Here the face-rhs build, the Thomas recurrence and the divergence
accumulation run in one pass along each line, as in ``ops/pallas_tridiag.py``
(same (B, n, M) line view, same lane and loop scheme).

Per-direction recurrence (f = face 0..n, e = cell 0..n-1; BX0/BX1 are the two
scalar divergence-pairing entries, reference FEM.cpp:822-831):

    rF_f  = BX1 v_{f-1} + BX0 v_f                (v out of range = 0)
    z_0   = rF_0 si;    z_f = rF_f si - l_{f-1} z_{f-1}       [si = 1/m_t]
    F_n   = z_n dm_n;   F_f = z_f dm_f - l_f F_{f+1}          [dm = dinv*mask]
    out_e = acc_e + BX0 F_e + BX1 F_{e+1}

The rhs scale is the static scalar si = 1/m_t and needs no mask: a pinned face
f (mask 0) has l_f = 0 and dm_f = 0 (the context zeroes its off-diagonal before
factorising), so a wrong z_f there is multiplied by an exact zero on every path
to an output.  ``tests/test_pallas_fused.py::test_pinned_face_factors_are_zero``
pins that invariant.

z_f for f < n is kept in the output array between the two sweeps (the backward
sweep reads z_e before it overwrites cell e), and z_n stays in registers.

Scope: RT0 (P = T = 1, no bubbles), no PERIODIC direction.  Everything else
uses the composable ops in apply.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .pallas_tridiag import (
    NUM_WARPS,
    TL,
    UNROLL,
    _chunked,
    _lanes,
    line_block,
    lines_geometry,
)

__all__ = ["fused_schur_dir"]


def _fused_kernel(acc_ref, v_ref, dm_ref, l_ref, o_ref, *, n, M, n_lines, tl,
                  unroll, bx0, bx1, si):
    """acc, v, o: n cells per line; dm: n + 1 faces; l: n."""
    q, ok = _lanes(n_lines, tl)
    b, m = q // M, q % M
    base = b * (n * M) + m  # cells
    fbase = b * ((n + 1) * M) + m  # faces
    ld = lambda ref, off: plgpu.load(ref.at[off])
    st = lambda off, val: plgpu.store(o_ref.at[off], val, mask=ok)

    v0 = ld(v_ref, base)
    z = (bx0 * v0) * si
    st(base, z)

    def fwd(f, vl, carry):
        z, v_prev = carry
        v_f, l_prev = vl
        z = (bx1 * v_prev + bx0 * v_f) * si - l_prev * z
        st(base + f * M, z)
        return z, v_f

    z, v_last = _chunked(1, n, unroll,
                         lambda f: (ld(v_ref, base + f * M), ld(l_ref, base + (f - 1) * M)),
                         fwd, (z, v0))
    z_n = (bx1 * v_last) * si - ld(l_ref, base + (n - 1) * M) * z
    f_next = z_n * ld(dm_ref, fbase + n * M)

    def bwd(e, zdla, f_next):
        z_e, dm_e, l_e, acc_e = zdla
        f_e = z_e * dm_e - l_e * f_next
        st(base + e * M, acc_e + bx0 * f_e + bx1 * f_next)
        return f_e

    _chunked(n - 1, -1, unroll,
             lambda e: (ld(o_ref, base + e * M), ld(dm_ref, fbase + e * M),
                        ld(l_ref, base + e * M), ld(acc_ref, base + e * M)),
             bwd, f_next)


@functools.partial(jax.jit, static_argnames=("B", "n", "M", "bx0", "bx1", "si",
                                             "tl", "num_warps", "unroll",
                                             "interpret"))
def _fused_lines(acc, v, dm, l, *, B, n, M, bx0, bx1, si, tl, num_warps, unroll,
                 interpret):
    n_lines = B * M
    tl = line_block(n_lines, tl)
    kern = functools.partial(_fused_kernel, n=n, M=M, n_lines=n_lines, tl=tl,
                             unroll=unroll, bx0=bx0, bx1=bx1, si=si)
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(v.shape, v.dtype),
        grid=(pl.cdiv(n_lines, tl),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="fused_schur_dir",
    )(acc, v, dm, l)


def fused_schur_dir(acc, v, dinvm, l, axis: int, bx0: float, bx1: float,
                    si: float, interpret: bool = False):
    """acc + B_d A_d^{-1} B_d^T v for an RT0 direction.

    acc, v: cell grids (..., nz, ny, nx); dinvm = dinv*mask (n + 1 faces along
    ``axis``) and l (n entries along ``axis``) broadcast against them; si = 1/m_t.
    """
    axis = axis % v.ndim
    shape = v.shape
    B, n, M = lines_geometry(shape, axis)
    fshape = shape[:axis] + (n + 1,) + shape[axis + 1:]
    dm_b = jnp.broadcast_to(dinvm, fshape)
    l_b = jnp.broadcast_to(l, shape)
    kw = dict(bx0=float(bx0), bx1=float(bx1), si=float(si), tl=TL,
              num_warps=NUM_WARPS, unroll=UNROLL, interpret=interpret)
    if M == 1:  # x: lines made contiguous, as in thomas_solve
        t = lambda a, k: a.reshape(B, k).T.reshape(-1)
        out = _fused_lines(t(acc, n), t(v, n), t(dm_b, n + 1), t(l_b, n),
                           B=1, n=n, M=B, **kw)
        return out.reshape(n, B).T.reshape(shape)
    out = _fused_lines(acc.reshape(-1), v.reshape(-1), dm_b.reshape(-1),
                       l_b.reshape(-1), B=B, n=n, M=M, **kw)
    return out.reshape(shape)
