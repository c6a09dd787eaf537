"""Batched parallel tridiagonal solve vs numpy dense solve."""

import numpy as np
import pytest

import jax.numpy as jnp

from neutfem_jax import config  # noqa: F401  (enable x64)
from neutfem_jax.ops.tridiag import tridiag_factor, tridiag_solve


@pytest.mark.parametrize("n", [1, 2, 3, 7, 33])
@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_tridiag_solve_matches_dense(n, batch):
    rng = np.random.default_rng(42 + n)
    off = rng.uniform(-0.4, 0.4, size=batch + (max(n - 1, 0),))
    diag = rng.uniform(2.0, 3.0, size=batch + (n,))  # diagonally dominant SPD

    rhs = rng.normal(size=batch + (n, 5))  # trailing mode batch

    dinv, l = tridiag_factor(jnp.asarray(diag), jnp.asarray(off), axis=-1)
    x = tridiag_solve(jnp.asarray(rhs), dinv[..., None], l[..., None], axis=-2)
    x = np.asarray(x)

    # dense check per batch entry
    it = np.ndindex(*batch) if batch else [()]
    for idx in it:
        T = np.diag(diag[idx])
        for i in range(n - 1):
            T[i, i + 1] = off[idx][i]
            T[i + 1, i] = off[idx][i]
        expect = np.linalg.solve(T, rhs[idx])
        np.testing.assert_allclose(x[idx], expect, rtol=1e-10, atol=1e-10)


def test_solve_axis_middle():
    rng = np.random.default_rng(0)
    n = 9
    diag = rng.uniform(2, 3, size=(2, n, 4))
    off = rng.uniform(-0.5, 0.5, size=(2, n - 1, 4))
    rhs = rng.normal(size=(2, n, 4))
    dinv, l = tridiag_factor(jnp.asarray(diag), jnp.asarray(off), axis=1)
    x = np.asarray(tridiag_solve(jnp.asarray(rhs), dinv, l, axis=1))
    for b in range(2):
        for c in range(4):
            T = np.diag(diag[b, :, c])
            for i in range(n - 1):
                T[i, i + 1] = T[i + 1, i] = off[b, i, c]
            np.testing.assert_allclose(
                x[b, :, c], np.linalg.solve(T, rhs[b, :, c]), rtol=1e-10, atol=1e-10
            )
