"""Explicit-Schur direct solver path (ops/direct.py).

The analogue of the reference's explicit Schur + direct factorization
(/root/reference/src/solvers.cpp:259-427, selected by LinearSolverType DIRECT_*
in SchurSolver::PrepareSolver, :328-427).  The dense path must reproduce the
matrix-free CG eigenvalue exactly (same discrete operator, different solve), and
must gate itself above NEUTFEM_DIRECT_MAX_NPHI with a loud CG fallback.
"""

import numpy as np
import pytest

from neutfem import BCType, BoundaryID, LinearSolverType, NeutFEM, VerbosityLevel

from test_compat_api import fill_uniform_xs, make_solver_2d


def _solve_with(solver_type, n=8, order=0):
    s = make_solver_2d(n, order=order)
    for bid in (BoundaryID.LEFT_2D, BoundaryID.RIGHT_2D, BoundaryID.TOP_2D,
                BoundaryID.BOTTOM_2D):
        s.set_bc(int(bid), BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_linear_solver(solver_type)
    s.set_tol(1e-8, 1e-8, 1e-8, 300, 2000)
    k = s.SolveKeff()
    return s, k


@pytest.mark.parametrize("direct_type", [
    LinearSolverType.DIRECT_LU,
    LinearSolverType.DIRECT_LDLT,
    LinearSolverType.DIRECT_LLT,
])
def test_direct_matches_cg_eigenvalue(direct_type):
    _, k_cg = _solve_with(LinearSolverType.CG)
    s, k_direct = _solve_with(direct_type)
    assert s.GetSolverName().startswith(("SparseLU", "Simplicial"))
    # identical discrete operator; the direct solve is exact, so agreement is
    # limited only by the outer-iteration tolerance
    assert abs(k_direct - k_cg) < 1e-7
    # the direct path reports one "iteration" per group solve, not a Krylov count
    assert s.GetLastIterations() == 1
    assert s.GetLastResidual() == 0.0


def test_direct_higher_order_rt1p1():
    """The dense S path must also cover RT1-P1 (bubble DOFs + exact A-solve)."""
    _, k_cg = _solve_with(LinearSolverType.CG, n=6, order=1)
    _, k_direct = _solve_with(LinearSolverType.DIRECT_LLT, n=6, order=1)
    assert abs(k_direct - k_cg) < 1e-7


def test_dense_schur_matches_matvec():
    """The materialized S must agree with the matrix-free schur_matvec column by
    column (same operator, two independent evaluation orders)."""
    import jax.numpy as jnp
    from neutfem_jax.ops.apply import schur_matvec
    from neutfem_jax.ops.direct import dense_schur_group
    from neutfem_jax.power import ctx_group

    s = make_solver_2d(5)
    for bid in range(1, 5):
        s.set_bc(bid, BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s, 5)
    s.BuildMatrices()
    ctx = s._ctx("exact")
    ctxg = ctx_group(ctx, 0)
    S = dense_schur_group(s._fes, ctxg, "exact")
    # symmetry (the enforced symmetrization must be a no-op up to roundoff)
    assert float(jnp.max(jnp.abs(S - S.T))) < 1e-10
    rng = np.random.default_rng(0)
    v = rng.standard_normal(s._fes.n_phi)
    shape = (s._fes.P, *s._mesh.shape)  # internal mode-first layout
    ref = schur_matvec(s._fes, ctxg, jnp.asarray(v.reshape(shape), S.dtype),
                       a_mode="exact").reshape(-1)
    got = S @ jnp.asarray(v, S.dtype)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-8, atol=1e-10)
    # SPD: all Cholesky pivots finite
    L = np.linalg.cholesky(np.asarray(S, dtype=np.float64))
    assert np.all(np.isfinite(L))


def test_direct_gate_falls_back_to_cg(monkeypatch):
    monkeypatch.setenv("NEUTFEM_DIRECT_MAX_NPHI", "16")
    s = make_solver_2d(8)
    for bid in range(1, 5):
        s.set_bc(bid, BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s, 8)
    s.BuildMatrices()
    s.set_linear_solver(LinearSolverType.DIRECT_LU)
    with pytest.warns(RuntimeWarning, match="gated to n_phi"):
        k = s.SolveKeff()
    assert 0.5 < k < 2.0
    # and nothing dense was attached to the context
    assert "schur_chol" not in s._ctx_cache["exact"]


def test_direct_adjoint_and_fixed_source():
    """The direct path plugs into every solve kind (adjoint reuses S: symmetric)."""
    s, k = _solve_with(LinearSolverType.DIRECT_LLT)
    k_adj = s.SolveAdjoint(use_direct_keff=False)
    assert abs(k_adj - k) < 1e-6
