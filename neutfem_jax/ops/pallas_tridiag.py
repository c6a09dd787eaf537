"""Pallas (Triton route) kernels: batched Thomas solve for the per-direction RT
mass systems.

The portable path (``ops/tridiag._scan_solve``) runs two ``associative_scan``s,
about 2·log2(n) passes over the face arrays.  The solve is memory-bound, so the
Thomas algorithm reads each operand once and writes the solution once instead.

Layout.  An array whose solve axis is ``axis`` is viewed (a free reshape) as
``(B, n, M)``: B leading lines, n the solve axis, M the trailing dims.  A line is
one (b, m) pair and its entries sit M elements apart, so the kernel works on the
flat array: each program owns ``tl`` consecutive lines (one per lane) and loops
over the solve axis.  For z and y the lines are the contiguous axis, so each
step's loads coalesce.  For x (M == 1) the solve axis is the contiguous one;
``thomas_solve`` then transposes the (B, n) view to (n, B) around the kernel (on
the H100 at IAEA-3D 6x6x4 widths this ran about twice as fast as loading each
step strided).

Each loop chunk issues the loads of ``unroll`` steps before the dependent
arithmetic, so several loads are in flight per lane.

Lanes past the last line wrap around to lines of the first program and are
masked on store; ``tl`` never exceeds the line count, so no two lanes of one
program share a line (interpret mode then stays exact too).

Reference counterpart: the unused serial ``ThomasSolver`` of the reference
(solvers.cpp:940-989) and the per-CG-iteration implicit A-solve inside
SchurProduct (solvers.cpp:535-547).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["thomas_solve", "kernel_mode", "line_block", "lines_geometry"]

#: lines per program and warps per program (one line per lane at 32 x warps);
#: with UNROLL the fastest setting of those timed on the H100 (PERF.md)
TL = 64
NUM_WARPS = 2
#: solve-axis steps whose loads are issued together
UNROLL = 16


def kernel_mode() -> str | None:
    """Which kernel path the dispatchers take: ``"gpu"`` (compiled for the card),
    ``"interpret"`` (``NEUTFEM_PALLAS_INTERPRET=1``, CPU tests only) or None
    (``NEUTFEM_PALLAS=0``, or a backend without the kernels: plain XLA).

    Interpret mode on a GPU backend is refused: it would run the kernel as a
    slow emulation on the card instead of the compiled kernel."""
    import os

    if os.environ.get("NEUTFEM_PALLAS", "1") == "0":
        return None
    backend = jax.default_backend()
    if os.environ.get("NEUTFEM_PALLAS_INTERPRET", "0") == "1":
        if backend == "gpu":
            raise RuntimeError(
                "NEUTFEM_PALLAS_INTERPRET=1 on a GPU backend: the kernels run "
                "compiled there; unset it")
        return "interpret"
    return "gpu" if backend == "gpu" else None


def lines_geometry(shape, axis: int):
    """(B, n, M) view of an array of ``shape`` for a solve along ``axis``."""
    axis = axis % len(shape)
    return (math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:]))


def line_block(n_lines: int, tl: int = TL) -> int:
    """Lines per program: ``tl``, halved until it does not exceed the line count
    (a power of two, as Triton tensors must be)."""
    while tl > 1 and tl > n_lines:
        tl //= 2
    return tl


def _lanes(n_lines: int, tl: int):
    """Line index per lane and its store mask (lanes past the end wrap)."""
    q = pl.program_id(0) * tl + jnp.arange(tl, dtype=jnp.int32)
    ok = q < n_lines
    return jnp.where(ok, q, q - n_lines), ok


def _chunked(lo: int, hi: int, unroll: int, load, step, carry):
    """Run ``carry = step(i, loaded_i, carry)`` for i in [lo, hi) (negative
    stride when lo > hi), issuing ``unroll`` steps' loads before their
    arithmetic."""
    sgn = 1 if hi >= lo else -1
    count = abs(hi - lo)
    nchunk = count // unroll

    def chunk(c, carry):
        i0 = lo + sgn * c * unroll
        vals = [load(i0 + sgn * k) for k in range(unroll)]
        for k in range(unroll):
            carry = step(i0 + sgn * k, vals[k], carry)
        return carry

    if nchunk:
        carry = jax.lax.fori_loop(0, nchunk, chunk, carry)

    def single(c, carry):
        i = lo + sgn * c
        return step(i, load(i), carry)

    if count - nchunk * unroll:
        carry = jax.lax.fori_loop(nchunk * unroll, count, single, carry)
    return carry


def _thomas_kernel(r_ref, d_ref, l_ref, o_ref, *, n, M, n_lines, tl, unroll):
    """Forward:  z_0 = r_0;  z_i = r_i - l_{i-1} z_{i-1}  (z stored in o)
    Backward: x_{n-1} = z_{n-1} d_{n-1};  x_i = z_i d_i - l_i x_{i+1}."""
    q, ok = _lanes(n_lines, tl)
    b, m = q // M, q % M
    base = b * (n * M) + m  # r, d, o: n entries per line
    lbase = b * ((n - 1) * M) + m  # l: n - 1 entries per line
    ld = lambda ref, off: plgpu.load(ref.at[off])
    st = lambda off, val: plgpu.store(o_ref.at[off], val, mask=ok)

    z = ld(r_ref, base)
    st(base, z)

    def fwd(i, rl, z):
        r_i, l_prev = rl
        z = r_i - l_prev * z
        st(base + i * M, z)
        return z

    z = _chunked(1, n, unroll,
                 lambda i: (ld(r_ref, base + i * M), ld(l_ref, lbase + (i - 1) * M)),
                 fwd, z)
    x = z * ld(d_ref, base + (n - 1) * M)
    st(base + (n - 1) * M, x)

    def bwd(i, zdl, x):
        z_i, d_i, l_i = zdl
        x = z_i * d_i - l_i * x
        st(base + i * M, x)
        return x

    _chunked(n - 2, -1, unroll,
             lambda i: (ld(o_ref, base + i * M), ld(d_ref, base + i * M),
                        ld(l_ref, lbase + i * M)),
             bwd, x)


@functools.partial(jax.jit, static_argnames=("B", "n", "M", "tl", "num_warps",
                                             "unroll", "interpret"))
def _solve_lines(r, d, l, *, B, n, M, tl, num_warps, unroll, interpret):
    """Flat operands of the (B, n, M) view -> flat solution."""
    n_lines = B * M
    tl = line_block(n_lines, tl)
    kern = functools.partial(_thomas_kernel, n=n, M=M, n_lines=n_lines, tl=tl,
                             unroll=unroll)
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(r.shape, r.dtype),
        grid=(pl.cdiv(n_lines, tl),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="thomas_solve",
    )(r, d, l)


def thomas_solve(rhs, dinv, l, axis: int, interpret: bool = False, *,
                 tl: int = TL, num_warps: int = NUM_WARPS, unroll: int = UNROLL):
    """Tridiagonal solve along ``axis`` with precomputed LDL^T factors (same
    semantics as ops.tridiag.tridiag_solve).  dinv/l must be broadcastable to
    rhs (dinv to rhs.shape, l to rhs.shape with n - 1 along ``axis``)."""
    axis = axis % rhs.ndim
    shape = rhs.shape
    B, n, M = lines_geometry(shape, axis)
    dinv_b = jnp.broadcast_to(dinv, shape)
    l_b = jnp.broadcast_to(l, shape[:axis] + (n - 1,) + shape[axis + 1:])
    kw = dict(tl=tl, num_warps=num_warps, unroll=unroll, interpret=interpret)
    if M == 1:
        # solve axis contiguous: lay the lines out contiguous instead
        t = lambda a, k: a.reshape(B, k).T.reshape(-1)
        out = _solve_lines(t(rhs, n), t(dinv_b, n), t(l_b, n - 1),
                           B=1, n=n, M=B, **kw)
        return out.reshape(n, B).T.reshape(shape)
    out = _solve_lines(rhs.reshape(-1), dinv_b.reshape(-1), l_b.reshape(-1),
                       B=B, n=n, M=M, **kw)
    return out.reshape(shape)
