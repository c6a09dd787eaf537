"""Pallas (Triton route) Thomas kernel vs the associative_scan reference, in
interpret mode on CPU.

Covers the (B, n, M) line view for every solve-axis position (z/y: lines
contiguous; x: the transposed layout), programs with fewer lines than the
default block, ragged last programs, broadcast factors, and the Python that
chooses the path (``use_thomas``, ``kernel_mode``, ``line_block``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.ops import pallas_tridiag
from neutfem_jax.ops.pallas_tridiag import kernel_mode, line_block, lines_geometry, thomas_solve
from neutfem_jax.ops.tridiag import MAX_THOMAS_N, tridiag_factor, tridiag_solve, use_thomas

DT = config.real_dtype


def _problem(shape, axis, seed=3):
    rng = np.random.default_rng(seed)
    off_shape = list(shape)
    off_shape[axis] = shape[axis] - 1
    diag = jnp.asarray(rng.uniform(2.0, 3.0, shape), DT)
    off = jnp.asarray(rng.uniform(-0.5, 0.5, off_shape), DT)
    rhs = jnp.asarray(rng.normal(size=shape), DT)
    dinv, l = tridiag_factor(diag, off, axis=axis)
    return rhs, dinv, l


def _tol():
    return dict(rtol=5e-12, atol=5e-13) if DT == jnp.float64 else dict(rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize(
    "shape,axis,case",
    [
        ((2, 13, 7, 90), 1, "z: M = 630, ragged last program"),
        ((2, 33, 3, 64), 1, "z: M exactly a multiple of the block"),
        ((4, 33, 150), 1, "y: trailing M = 150"),
        ((40, 33, 128), 1, "y: many leading lines"),
        ((7, 90, 13), 2, "x: solve axis contiguous, 630 lines"),
        ((3, 101, 257), 2, "x: long axis, ragged"),
        ((2, 4, 70), 1, "n = 4, the shortest accepted axis"),
        ((1, 5, 3), 2, "5 lines: block halved below the line count"),
        ((1, 1, 120, 8), 2, "y with a size-1 leading axis"),
        ((1, 60, 9), 2, "x: a fine 2D core row"),
        ((2, 40, 1, 64), 1, "z with a size-1 middle axis"),
    ],
)
def test_thomas_matches_scan(shape, axis, case):
    rhs, dinv, l = _problem(list(shape), axis)
    want = tridiag_solve(rhs, dinv, l, axis=axis)  # CPU: the scan path
    got = thomas_solve(rhs, dinv, l, axis=axis, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **_tol(), err_msg=case)


def test_thomas_declines_overlong_solve_axis():
    """The shape rule decides by the length of the solve axis alone: 4 to
    MAX_THOMAS_N entries go to the kernel, whatever the line count; longer and
    shorter axes go to the scan."""
    assert MAX_THOMAS_N == 256
    assert not use_thomas((1, 2300, 700), 1)   # long y axis, 700 lines
    assert not use_thomas((1, 640, 1520), 2)   # long x axis, 640 lines
    assert not use_thomas((1, 257, 9), 1)
    assert use_thomas((1, 256, 9), 1)
    assert not use_thomas((1, 3, 700), 1)      # n < 4
    assert use_thomas((1, 4, 700), 1)
    assert use_thomas((1, 40, 12), 1)          # 12 lines
    assert use_thomas((100000, 9), 1)          # 100,000 lines
    # the kernel itself still produces the right answer on a long axis
    rhs, dinv, l = _problem([1, 40, 600], 2)
    got = thomas_solve(rhs, dinv, l, axis=2, interpret=True)
    want = tridiag_solve(rhs, dinv, l, axis=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **_tol())


def test_thomas_broadcast_trailing_mode():
    """solve_A_dir broadcasts dinv/l over a transverse-mode axis.  The scan
    path (the CPU dispatcher's) must match a dense solve, and the kernel must
    match the scan."""
    rng = np.random.default_rng(4)
    n, ny, T = 17, 40, 3
    diag = jnp.asarray(rng.uniform(2.0, 3.0, (ny, n)), DT)
    off = jnp.asarray(rng.uniform(-0.4, 0.4, (ny, n - 1)), DT)
    rhs = jnp.asarray(rng.normal(size=(ny, n, T)), DT)
    dinv, l = tridiag_factor(diag, off, axis=-1)
    assert kernel_mode() is None  # CPU: the scan path
    want = tridiag_solve(rhs, dinv[..., None], l[..., None], axis=1)
    dense = np.zeros((n, n))
    i = np.arange(n)
    dense[i, i] = np.asarray(diag[0])
    dense[i[:-1], i[:-1] + 1] = np.asarray(off[0])
    dense[i[:-1] + 1, i[:-1]] = np.asarray(off[0])
    x = np.linalg.solve(dense, np.asarray(rhs[0, :, 0]))
    np.testing.assert_allclose(np.asarray(want[0, :, 0]), x, rtol=1e-5, atol=1e-6)
    # the kernel itself handles the broadcast factors too
    got = thomas_solve(rhs, dinv[..., None], l[..., None], axis=1, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **_tol())


def test_thomas_mode_axis_broadcast_on_kernel_path(monkeypatch):
    """A trailing mode axis wide enough for the kernel: the production
    dispatcher (interpret mode) takes it and matches the scan."""
    rng = np.random.default_rng(5)
    n, ny, T = 17, 40, 64
    diag = jnp.asarray(rng.uniform(2.0, 3.0, (ny, n)), DT)
    off = jnp.asarray(rng.uniform(-0.4, 0.4, (ny, n - 1)), DT)
    rhs = jnp.asarray(rng.normal(size=(ny, n, T)), DT)
    dinv, l = tridiag_factor(diag, off, axis=-1)
    want = tridiag_solve(rhs, dinv[..., None], l[..., None], axis=1)
    assert use_thomas(rhs.shape, 1)
    monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    got = tridiag_solve(rhs, dinv[..., None], l[..., None], axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **_tol())


def test_kernel_mode(monkeypatch):
    """gpu -> compiled kernels; NEUTFEM_PALLAS=0 -> none; interpret only off
    the GPU (it raises there rather than emulating the kernel on the card)."""
    monkeypatch.delenv("NEUTFEM_PALLAS", raising=False)
    monkeypatch.delenv("NEUTFEM_PALLAS_INTERPRET", raising=False)
    assert kernel_mode() is None  # CPU backend
    monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    assert kernel_mode() == "interpret"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="INTERPRET"):
        kernel_mode()
    monkeypatch.delenv("NEUTFEM_PALLAS_INTERPRET")
    assert kernel_mode() == "gpu"
    monkeypatch.setenv("NEUTFEM_PALLAS", "0")
    assert kernel_mode() is None


def test_line_block_and_geometry():
    assert line_block(10_000) == pallas_tridiag.TL
    assert line_block(5) == 4 and line_block(1) == 1 and line_block(64, 64) == 64
    assert line_block(63, 64) == 32
    assert lines_geometry((2, 3, 4, 5), 1) == (2, 3, 20)
    assert lines_geometry((2, 3, 4, 5), -1) == (24, 5, 1)
    assert lines_geometry((7, 9), 0) == (1, 7, 9)


@pytest.mark.parametrize("tl,unroll", [(32, 1), (16, 3), (64, 16)])
def test_thomas_block_and_unroll_settings(tl, unroll):
    """Every block width and unroll depth gives the same solve (the loop
    remainder and the chunked loads are exercised)."""
    rhs, dinv, l = _problem([3, 23, 40], 1)
    want = tridiag_solve(rhs, dinv, l, axis=1)
    got = thomas_solve(rhs, dinv, l, axis=1, interpret=True, tl=tl, unroll=unroll)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **_tol())


@pytest.mark.gpu
def test_thomas_compiled_on_gpu():
    """The kernel as compiled for the card against the scan (runs only where
    JAX finds a GPU)."""
    if jax.default_backend() != "gpu":
        pytest.skip("no GPU: the compiled kernel runs only on the card")
    for shape, axis in (((1, 77, 114, 114), 1), ((1, 76, 115, 114), 2),
                        ((1, 76, 114, 115), 3)):
        rhs, dinv, l = _problem(list(shape), axis)
        rhs, dinv, l = (a.astype(jnp.float32) for a in (rhs, dinv, l))
        got = jax.jit(lambda r, d, lo: thomas_solve(r, d, lo, axis))(rhs, dinv, l)
        from neutfem_jax.ops.tridiag import _scan_solve

        want = _scan_solve(rhs, dinv, l, axis)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
