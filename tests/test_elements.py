"""Unit tests for the reference-element tensors (exactness properties)."""

import numpy as np
import pytest

from neutfem_jax.elements import element_tensors, gauss_rule, legendre_table


def test_legendre_orthogonality():
    x, w = gauss_rule(12)
    P = legendre_table(6, x)
    M = np.einsum("iq,jq,q->ij", P, P, w)
    expect = np.diag(2.0 / (2.0 * np.arange(7) + 1.0))
    np.testing.assert_allclose(M, expect, atol=1e-13)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_M1_spd_and_partition(k):
    et = element_tensors(k, k)
    np.testing.assert_allclose(et.M1, et.M1.T, atol=1e-14)
    assert np.all(np.linalg.eigvalsh(et.M1) > 0)
    # u_0 + u_1 = 1 identically; bubbles integrate the same against anything linear?
    # Row sums of the face block: int u_i * (u_0+u_1) = int u_i = 1 for faces.
    np.testing.assert_allclose(et.M1[:2, :2].sum(axis=1) + et.M1[:2, 2:].sum(axis=1) * 0,
                               et.M1[:2, :2].sum(axis=1), atol=1e-14)
    np.testing.assert_allclose(et.M1_lumped[:2] if k == 0 else et.M1.sum(axis=1)[:2],
                               et.M1.sum(axis=1)[:2], atol=1e-14)


def test_rt0_exact_values():
    et = element_tensors(0, 0)
    np.testing.assert_allclose(et.M1, [[2 / 3, 1 / 3], [1 / 3, 2 / 3]], atol=1e-14)
    np.testing.assert_allclose(et.M1_lumped, [1.0, 1.0], atol=1e-14)
    np.testing.assert_allclose(et.D1, [[-1.0, 1.0]], atol=1e-14)
    np.testing.assert_allclose(et.K, et.M1, atol=1e-14)


@pytest.mark.parametrize("k,m", [(1, 0), (1, 1), (2, 1), (2, 2)])
def test_divergence_pairing_integration_by_parts(k, m):
    """∫ P_p u_i' = [P_p u_i] - ∫ P_p' u_i ; check via quadrature."""
    et = element_tensors(k, m)
    x, w = gauss_rule(k + m + 4)
    U, dU = et.eval_long(x)
    P = legendre_table(m, x)
    D_quad = np.einsum("pq,iq,q->pi", P, dU, w)
    np.testing.assert_allclose(et.D1, D_quad, atol=1e-13)
    # bubbles vanish at +-1 => ∫ P_0 u_bub' = 0
    np.testing.assert_allclose(et.D1[0, 2:], 0.0, atol=1e-13)
    # faces: ∫ P_0 u_{L/R}' = -+1... u_L' = -1/2 -> -1; u_R' = +1/2 -> +1
    np.testing.assert_allclose(et.D1[0, :2], [-1.0, 1.0], atol=1e-13)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_condensation_identity(k):
    """K must equal the Schur complement of the bubble block of M1."""
    et = element_tensors(k, k)
    Mff, Mfb, Mbb = et.M1[:2, :2], et.M1[:2, 2:], et.M1[2:, 2:]
    np.testing.assert_allclose(et.K, Mff - Mfb @ np.linalg.inv(Mbb) @ Mfb.T, atol=1e-13)
    np.testing.assert_allclose(et.G, np.linalg.inv(Mbb) @ Mfb.T, atol=1e-13)


def test_infsup_guard():
    with pytest.raises(ValueError):
        element_tensors(0, 1)
