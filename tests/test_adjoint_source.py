"""Adjoint eigensolve and fixed-source (subcritical) solve tests.

Oracles: dense-assembled H/F matrices (see oracle.py + test_power.dense_keff) — the
adjoint eigenvalue of H^T x = (1/k) F^T x must equal the direct one, and the adjoint
flux must align with the left eigenvector.  Fixed-source solves are checked against a
direct dense linear solve of (H - F) phi = q.
"""

import numpy as np
import pytest
import scipy.linalg

import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.power import (
    SolveOptions,
    biorthogonal_inner,
    fixed_source_solve,
    power_iteration,
    solve_subcritical,
)
from neutfem_jax.ops.context import build_context

from oracle import DenseOracle
from test_power import build_2d_problem, dense_keff

DT = config.real_dtype


def dense_HF(oracle, xs, ng):
    """Assemble the dense multigroup (H, F) pair used by dense_keff."""
    fes = oracle.fes
    n = oracle.n_phi
    detJ = oracle.mesh.det_jac()
    w_mode = fes.w_mode

    def wmass(coeff):
        d = (coeff[..., None] * detJ[..., None] * w_mode).reshape(-1)
        return np.diag(d)

    H = np.zeros((ng * n, ng * n))
    F = np.zeros((ng * n, ng * n))
    for g in range(ng):
        H[g * n : (g + 1) * n, g * n : (g + 1) * n] = oracle.schur(g)
        chi_g = np.repeat(np.asarray(xs["Chi"][g]).reshape(-1), fes.P)
        for gp in range(ng):
            if gp != g:
                H[g * n : (g + 1) * n, gp * n : (gp + 1) * n] -= wmass(xs["SigS"][g, gp])
            F[g * n : (g + 1) * n, gp * n : (gp + 1) * n] = chi_g[:, None] * wmass(xs["NSF"][gp])
    return H, F


def test_adjoint_keff_equals_direct():
    mesh, fes, ng, xs, bcs = build_2d_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    opts = SolveOptions(tol_keff=1e-10, tol_flux=1e-8, inner_tol=1e-12)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)

    res_d = power_iteration(fes, ng, opts, ctx, phi0, 1.0)
    res_a = power_iteration(fes, ng, opts, ctx, phi0, 1.0, adjoint=True)
    assert abs(float(res_d["keff"]) - float(res_a["keff"])) < 5e-8


def test_adjoint_flux_is_left_eigenvector():
    mesh, fes, ng, xs, bcs = build_2d_problem(nx=5, ny=4)
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    oracle = DenseOracle(fes, ng, xs, bcs)
    H, F = dense_HF(oracle, xs, ng)

    # dense adjoint eigenvector: largest eigenpair of H^-T F^T
    vals, vecs = scipy.linalg.eig(np.linalg.solve(H.T, F.T))
    i = np.argmax(vals.real)
    v_ref = vecs[:, i].real
    v_ref = v_ref / np.linalg.norm(v_ref) * np.sign(v_ref.sum())

    opts = SolveOptions(tol_keff=1e-11, tol_flux=1e-9, inner_tol=1e-13)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)
    res = power_iteration(fes, ng, opts, ctx, phi0, 1.0, adjoint=True)
    v = np.asarray(res["phi"]).reshape(-1)
    v = v / np.linalg.norm(v) * np.sign(v.sum())
    assert np.max(np.abs(v - v_ref)) < 1e-6
    assert abs(float(res["keff"]) - float(np.max(vals.real))) < 5e-9


def test_adjoint_fixed_keff_mode():
    """use_direct_keff mode: k held at the direct value, flux still converges."""
    mesh, fes, ng, xs, bcs = build_2d_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    opts = SolveOptions(tol_keff=1e-10, tol_flux=1e-9, inner_tol=1e-12)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)

    k_direct = float(power_iteration(fes, ng, opts, ctx, phi0, 1.0)["keff"])
    res = power_iteration(
        fes, ng, opts, ctx, phi0, k_direct, adjoint=True, fixed_keff=k_direct
    )
    assert float(res["keff"]) == pytest.approx(k_direct)
    assert float(res["diff_flux"]) < opts.tol_flux


def test_biorthogonal_normalization():
    mesh, fes, ng, xs, bcs = build_2d_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    opts = SolveOptions(tol_keff=1e-10, tol_flux=1e-9, inner_tol=1e-12)
    phi0 = jnp.ones((ng, *mesh.shape, fes.P), dtype=DT)
    phi = power_iteration(fes, ng, opts, ctx, phi0, 1.0)["phi"]
    phi_adj = power_iteration(fes, ng, opts, ctx, phi0, 1.0, adjoint=True)["phi"]
    ip = biorthogonal_inner(ctx, phi, phi_adj)
    phi_adj = phi_adj / ip
    assert float(biorthogonal_inner(ctx, phi, phi_adj)) == pytest.approx(1.0, abs=1e-12)


def _subcritical_problem():
    mesh, fes, ng, xs, bcs = build_2d_problem()
    # scale fission so the system sits at k ~ 0.5 (subcritical but reactive enough
    # for a visible amplification factor), add an external source
    xs["NSF"] = 5.0 * xs["NSF"]
    xs["SRC"] = np.zeros((ng, *mesh.shape))
    xs["SRC"][0, mesh.nz // 2, mesh.ny // 2, mesh.nx // 2] = 1.0
    return mesh, fes, ng, xs, bcs


def test_fixed_source_matches_dense_solve():
    mesh, fes, ng, xs, bcs = _subcritical_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    oracle = DenseOracle(fes, ng, xs, bcs)
    H, F = dense_HF(oracle, xs, ng)

    detJ = mesh.det_jac()
    w0 = float(np.prod(2.0 * np.ones(mesh.dim)))  # w_mode[0] = 2^dim
    q = np.zeros((ng, *mesh.shape, fes.P))
    q[..., 0] = xs["SRC"] * detJ * w0 / (2.0 ** mesh.dim) * (2.0 ** mesh.dim)
    q_flat = q.reshape(-1)

    phi_ref = np.linalg.solve(H - F, q_flat).reshape(ng, *mesh.shape, fes.P)

    opts = SolveOptions(tol_flux=1e-12, inner_tol=1e-13, max_outer=500, accel="none")
    phi0 = jnp.zeros((ng, *mesh.shape, fes.P), dtype=DT)
    res = fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=True)
    err = np.max(np.abs(np.asarray(res["phi"]) - phi_ref)) / np.max(np.abs(phi_ref))
    assert err < 1e-8


def test_subcritical_amplification():
    mesh, fes, ng, xs, bcs = _subcritical_problem()
    ctx = build_context(fes, ng, xs, bcs, a_mode="exact", dtype=DT)
    opts = SolveOptions(tol_flux=1e-11, inner_tol=1e-13, max_outer=500, accel="none")
    phi0 = jnp.zeros((ng, *mesh.shape, fes.P), dtype=DT)
    res = solve_subcritical(fes, ng, opts, ctx, phi0)
    # fission must amplify the source-driven flux
    assert float(res["amplification"]) > 1.5
    assert np.all(np.isfinite(np.asarray(res["phi"])))
