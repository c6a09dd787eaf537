"""Internal axis orientation (compat layer).

The compat layer can solve an axis-RELABELED problem and convert at every IO
boundary.  Its own choice (``mesh.best_axis_order``) is the identity; these tests
pin the machinery through an explicit permutation, patched in where the compat
layer takes its choice (``_choose_axis_perm``): the relabeled
solve must be indistinguishable from the identity-orientation solve on every
public surface (eigenvalues, flux views, currents, projections, checkpoints, BC
handling), including higher orders where the flux-mode axis must be re-gathered.
"""

import numpy as np
import pytest

import neutfem._neutfem_eigen as compat
from neutfem import BCType, NeutFEM
from neutfem_jax.mesh import CartesianMesh, best_axis_order, boundary_attribute


PERM = (2, 1, 0)  # the relabelling the tests drive: user x <-> internal z
IDENT = (0, 1, 2)


def _orient(monkeypatch, perm):
    """Make the compat layer solve in internal axis order ``perm``."""
    monkeypatch.setattr(compat, "_choose_axis_perm", lambda mesh: perm)


def _mk(nx, ny, nz, rt_order=0, p_order=None, axisperm=PERM, monkeypatch=None,
        mirror_xhi=False):
    """Small heterogeneous 2-group core with axis-asymmetric XS; ``axisperm``
    None keeps the compat layer's own choice."""
    assert monkeypatch is not None
    if axisperm is not None:
        _orient(monkeypatch, axisperm)
    if p_order is None:
        p_order = rt_order
    s = NeutFEM(rt_order, p_order, 2, np.linspace(0.0, 15.0 * nx, nx + 1),
                np.linspace(0.0, 15.0 * ny, ny + 1), np.linspace(0.0, 15.0 * nz, nz + 1))
    for axis in range(3):
        for upper in (False, True):
            kind = BCType.MIRROR if (mirror_xhi and axis == 0 and upper) \
                else BCType.DIRICHLET
            s.set_bc(boundary_attribute(3, axis, upper), kind, 0.0)
    D = s.get_D(); SigR = s.get_SigR(); NSF = s.get_NSF(); Chi = s.get_Chi()
    SigS = s.get_SigS()
    D[0], D[1] = 1.4, 0.4
    SigR[0], SigR[1] = 0.03, 0.09
    NSF[0], NSF[1] = 0.005, 0.14
    Chi[0], Chi[1] = 1.0, 0.0
    SigS[1, 0] = 0.018
    # axis-asymmetric heterogeneity: gradient along z, absorber slab along y,
    # reflector-ish column along x — a wrong transpose changes the physics
    z = np.linspace(0.9, 1.2, nz)[:, None, None]
    D[0] = D[0] * z
    SigR[1, :, : max(ny // 3, 1), :] = 0.13
    NSF[1, :, :, : max(nx // 3, 1)] = 0.05
    s.BuildMatrices()
    s.set_tol(1e-7, 1e-7, 1e-7, 300, 400)
    return s


def test_choose_axis_perm_heuristic():
    """The compat layer takes the core's choice, which is the identity for
    every dimensionality and aspect ratio."""
    assert compat._choose_axis_perm is best_axis_order
    m3 = CartesianMesh.from_breaks(np.linspace(0, 1, 5), np.linspace(0, 1, 7),
                                   np.linspace(0, 1, 17))  # (nx,ny,nz)=(4,6,16)
    m3b = CartesianMesh.from_breaks(np.linspace(0, 1, 129), np.linspace(0, 1, 3),
                                    np.linspace(0, 1, 4))  # (128,2,3)
    m2 = CartesianMesh.from_breaks(np.linspace(0, 1, 5), np.linspace(0, 1, 17))
    m1 = CartesianMesh.from_breaks(np.linspace(0, 1, 5))
    for m in (m3, m3b, m2, m1):
        assert best_axis_order(m) == IDENT


def test_axisperm_env_disables(monkeypatch):
    """Without a patched permutation the solver works in user orientation."""
    s = _mk(4, 6, 16, axisperm=None, monkeypatch=monkeypatch)
    assert s._axperm == IDENT and s._imesh is s._mesh


@pytest.mark.parametrize("mirror_xhi", [False, True])
def test_rt0_solve_matches_identity(monkeypatch, mirror_xhi):
    """k, flux, adjoint, currents and iteration history must be orientation-
    independent.  The mirror_xhi variant pins the boundary-attribute remap
    (a mis-mapped MIRROR face moves k by far more than the tolerance)."""
    sp = _mk(4, 6, 16, monkeypatch=monkeypatch, mirror_xhi=mirror_xhi)
    assert sp._axperm == (2, 1, 0)
    s0 = _mk(4, 6, 16, axisperm=IDENT, monkeypatch=monkeypatch, mirror_xhi=mirror_xhi)
    kp, k0 = sp.SolveKeff(), s0.SolveKeff()
    assert abs(kp - k0) < 1e-10
    np.testing.assert_allclose(sp.get_flux(), s0.get_flux(), rtol=1e-7, atol=1e-9)
    assert sp.get_flux().shape == (2, 16, 6, 4)
    kap, ka0 = sp.SolveAdjoint(), s0.SolveAdjoint()
    assert abs(kap - ka0) < 1e-9
    np.testing.assert_allclose(sp.get_flux_adj(), s0.get_flux_adj(),
                               rtol=1e-6, atol=1e-8)
    # cell-average current vectors: spatial axes AND components de-permuted
    cp, c0 = sp._cell_current(sp._J), s0._cell_current(s0._J)
    np.testing.assert_allclose(cp, c0, rtol=1e-6, atol=1e-9)
    # same outer-iteration history (identical math, relabeled axes)
    assert sp._last_outers == s0._last_outers


def test_rt1_solve_and_projection_match_identity(monkeypatch):
    """Higher order: the flux-mode axis must be re-gathered (mode (px,py,pz)
    exponents permute with the axes); project_flux exercises every mode."""
    sp = _mk(4, 6, 16, rt_order=1, monkeypatch=monkeypatch)
    assert sp._axperm == (2, 1, 0) and sp._fes.P == 8
    s0 = _mk(4, 6, 16, rt_order=1, axisperm=IDENT, monkeypatch=monkeypatch)
    kp, k0 = sp.SolveKeff(), s0.SolveKeff()
    assert abs(kp - k0) < 1e-9
    np.testing.assert_allclose(sp.get_flux(), s0.get_flux(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sp.project_flux((2, 2, 2)),
                               s0.project_flux((2, 2, 2)), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sp.project_power((2, 1, 2)),
                               s0.project_power((2, 1, 2)), rtol=1e-6, atol=1e-8)


def test_coarse_init_and_zoom_match_identity(monkeypatch):
    sp = _mk(4, 6, 16, monkeypatch=monkeypatch)
    s0 = _mk(4, 6, 16, axisperm=IDENT, monkeypatch=monkeypatch)
    kp = sp.SolveKeff(use_coarse_init=True, coarse_factors=(2, 2, 2))
    k0 = s0.SolveKeff(use_coarse_init=True, coarse_factors=(2, 2, 2))
    assert abs(kp - k0) < 1e-10
    kcp, fp = sp.SolveCoarse((2, 2, 4))
    kc0, f0 = s0.SolveCoarse((2, 2, 4))
    assert abs(kcp - kc0) < 1e-10
    np.testing.assert_allclose(fp, f0, rtol=1e-7, atol=1e-10)
    # zoom re-solves on a user-orientation refined mesh from the frozen source
    sp.SolveKeff(); s0.SolveKeff()
    np.testing.assert_allclose(sp.zoom_resolved((2, 1, 1)),
                               s0.zoom_resolved((2, 1, 1)), rtol=1e-5, atol=1e-7)


def test_periodic_and_valued_neumann_match_identity(monkeypatch):
    """PERIODIC pairs and nonzero-NEUMANN values must survive the boundary-
    attribute remap: periodic on user x (which relabels to internal z under
    the (2,1,0) perm), a prescribed inward current on the -y face, Dirichlet
    elsewhere."""
    def build(axisperm):
        _orient(monkeypatch, axisperm)
        s = NeutFEM(0, 2, np.linspace(0.0, 60.0, 5), np.linspace(0.0, 90.0, 7),
                    np.linspace(0.0, 240.0, 17))
        for upper in (False, True):
            s.set_bc(boundary_attribute(3, 0, upper), BCType.PERIODIC, 0.0)
            s.set_bc(boundary_attribute(3, 2, upper), BCType.DIRICHLET, 0.0)
        s.set_bc(boundary_attribute(3, 1, False), BCType.NEUMANN, 0.35)
        s.set_bc(boundary_attribute(3, 1, True), BCType.DIRICHLET, 0.0)
        D = s.get_D(); SigR = s.get_SigR(); SigS = s.get_SigS()
        D[0], D[1] = 1.3, 0.5
        SigR[0], SigR[1] = 0.04, 0.11
        SigR[1, :, :, :2] = 0.16  # x-asymmetry (periodic direction)
        SigS[1, 0] = 0.02
        s.get_SRC()[:] = 0.4
        s.BuildMatrices()
        s.set_tol(1e-7, 1e-7, 1e-7, 200, 400)
        return s

    sp, s0 = build(PERM), build(IDENT)
    assert sp._axperm == (2, 1, 0) and s0._axperm == (0, 1, 2)
    # fixed-source subcritical solve exercises the source + BC machinery
    mp, m0 = sp.SolveSubcritical(), s0.SolveSubcritical()
    np.testing.assert_allclose(mp, m0, rtol=1e-10)
    np.testing.assert_allclose(sp.get_flux(), s0.get_flux(), rtol=1e-8,
                               atol=1e-11)


def test_checkpoint_roundtrip_across_orientations(tmp_path, monkeypatch):
    """Checkpoints store the flux in USER orientation: a state saved by a
    permuted solver restores into an identity-orientation solver (and warm-
    starts it); currents are dropped with a warning on orientation mismatch."""
    sp = _mk(4, 6, 16, monkeypatch=monkeypatch)
    kp = sp.SolveKeff()
    path = str(tmp_path / "state")
    sp.save_state(path)

    s0 = _mk(4, 6, 16, axisperm=IDENT, monkeypatch=monkeypatch)
    with pytest.warns(RuntimeWarning, match="internal axis order"):
        s0.load_state(path)
    assert s0._J is None
    np.testing.assert_allclose(s0.get_flux(), sp.get_flux(), rtol=1e-7, atol=1e-9)
    assert abs(s0.GetLastKeff() - kp) < 1e-12
    # warm start converges immediately to the same eigenvalue
    k0 = s0.SolveKeff()
    assert abs(k0 - kp) < 1e-8

    # same-orientation round-trip keeps the currents
    sp2 = _mk(4, 6, 16, monkeypatch=monkeypatch)
    sp2.load_state(path)
    assert sp2._J is not None
    np.testing.assert_allclose(sp2._cell_current(sp2._J),
                               sp._cell_current(sp._J), rtol=1e-7, atol=1e-10)


def test_vtk_export_orientation(tmp_path, monkeypatch):
    """VTK output must be identical bytes-for-values between orientations."""
    sp = _mk(4, 6, 16, monkeypatch=monkeypatch)
    s0 = _mk(4, 6, 16, axisperm=IDENT, monkeypatch=monkeypatch)
    sp.SolveKeff(); s0.SolveKeff()
    fa, fb = str(tmp_path / "a.vtk"), str(tmp_path / "b.vtk")
    sp.ExportVTK(fa, export_current=True, export_xs=True)
    s0.ExportVTK(fb, export_current=True, export_xs=True)
    ta, tb = open(fa).read(), open(fb).read()
    assert ta.split("\n")[:6] == tb.split("\n")[:6]  # same mesh header
    va = np.array([float(x) for x in ta.split() if _isfloat(x)])
    vb = np.array([float(x) for x in tb.split() if _isfloat(x)])
    assert va.size == vb.size
    np.testing.assert_allclose(va, vb, rtol=1e-6, atol=1e-9)


def _isfloat(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False
