"""Native host-kernel tests: C++ results must match the numpy fallbacks exactly."""

import numpy as np
import pytest

from neutfem_jax import native


def _numpy_ldlt(diag, off):
    n = diag.shape[-1]
    batch = int(np.prod(diag.shape[:-1]))
    d2 = diag.reshape(batch, n).copy()
    l2 = off.reshape(batch, n - 1).copy()
    dp = d2[:, 0].copy()
    for i in range(n - 1):
        li = l2[:, i] / dp
        dn = d2[:, i + 1] - l2[:, i] * li
        l2[:, i] = li
        d2[:, i] = 1.0 / dp
        dp = dn
    d2[:, n - 1] = 1.0 / dp
    return d2.reshape(diag.shape), l2.reshape(off.shape)


def test_library_built():
    assert native.available(), "native library did not build from source"
    assert native.LIB_PATH.exists()
    assert "build" in native.LIB_PATH.parts  # git-ignored build directory


def test_library_builds_from_tracked_source(tmp_path):
    """native.build compiles native/neutfem_host.cpp into any directory; the
    result loads and factorizes like the numpy fallback."""
    import ctypes

    lib_path = native.build(tmp_path / "libneutfem_host.so")
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(2)
    diag = np.ascontiguousarray(rng.uniform(2.0, 3.0, (3, 9)))
    off = np.ascontiguousarray(rng.uniform(-0.5, 0.5, (3, 8)))
    d, l = diag.copy(), off.copy()
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.nf_tridiag_ldlt_batch.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2 + [
        ctypes.c_int64] * 2
    lib.nf_tridiag_ldlt_batch(p(d), p(l), 3, 9)
    want_d, want_l = _numpy_ldlt(diag, off)
    np.testing.assert_allclose(d, want_d, rtol=1e-14)
    np.testing.assert_allclose(l, want_l, rtol=1e-14)


def test_tridiag_ldlt_matches_numpy():
    rng = np.random.default_rng(0)
    n = 37
    diag = rng.uniform(2.0, 3.0, (4, 5, n))
    off = rng.uniform(-0.5, 0.5, (4, 5, n - 1))
    dinv, l = native.tridiag_ldlt_batch(diag, off)
    dinv_np, l_np = _numpy_ldlt(diag, off)
    np.testing.assert_allclose(dinv, dinv_np, rtol=1e-14)
    np.testing.assert_allclose(l, l_np, rtol=1e-14)

    # and it must actually factorize: reconstruct T = L D L^T and check one solve
    D = np.diag(1.0 / dinv[0, 0])
    L = np.eye(n)
    for i in range(n - 1):
        L[i + 1, i] = l[0, 0, i]
    T = L @ D @ L.T
    T_ref = np.diag(diag[0, 0]) + np.diag(off[0, 0], 1) + np.diag(off[0, 0], -1)
    np.testing.assert_allclose(T, T_ref, atol=1e-12)


def test_block_mean_matches_numpy():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 4, 6, 8))
    w = rng.uniform(0.5, 2.0, (4, 6, 8))
    got = native.block_mean(a, w, (2, 3, 2))  # (rx, ry, rz)
    a6 = a.reshape(2, 2, 2, 2, 3, 4, 2)
    w6 = w.reshape(2, 2, 2, 3, 4, 2)
    want = (a6 * w6).sum(axis=(-5, -3, -1)) / w6.sum(axis=(-5, -3, -1))
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_native_vtk_writer(tmp_path):
    if not native.available():
        pytest.skip("native library not built")
    path = str(tmp_path / "out.vtk")
    xb = np.linspace(0, 2, 3)
    yb = np.linspace(0, 1, 2)
    zb = np.array([0.0, 1.0])
    ok = native.write_vtk_native(
        path, "title k=1.0", xb, yb, zb, 2,
        scalars=[("Flux_g0", np.array([1.0, 2.0]))],
        vectors=[("Current_g0", np.arange(6.0))],
    )
    assert ok
    text = open(path).read()
    assert "DATASET STRUCTURED_GRID" in text
    assert "SCALARS Flux_g0 double 1" in text
    assert "VECTORS Current_g0 double" in text
    assert "CELL_DATA 2" in text
