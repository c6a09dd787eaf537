"""Executable scipy transcription of the reference's discrete operator + power iteration.

This is an INDEPENDENT ground truth for eigenvalue adjudication (VERDICT round 1,
Missing #1): every formula is transcribed directly from the reference C++ sources
(file:line cited inline), assembled with scipy.sparse, and solved with the same
implicit-Schur CG + Chebyshev-accelerated power iteration the reference uses.  It
shares NOTHING with tests/oracle.py (dense JAX quadrature oracle) or with
neutfem_jax (separable-tensor operators): quadrature points, basis evaluation,
DOF numbering, assembly and the outer loop are all re-derived here from
/root/reference/src/{FEM,NeutFEM,solvers}.cpp.

It doubles as a *measured* CPU baseline for bench.py's vs_baseline (the reference
module itself cannot be built: its shipped sources have unresolved symbols,
SURVEY.md section 2.2 "Stubs").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

__all__ = ["ReplicaProblem", "assemble", "solve_keff", "replica_from_benchmark"]


# ---------------------------------------------------------------------------
# Legendre polynomials (FEM.hpp:139-201): Bonnet recurrence; dP with the
# boundary-limit handling at xi = +-1.
# ---------------------------------------------------------------------------

def _leg_P(n: int, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.ones_like(x)
    if n == 1:
        return x.copy()
    pm, p = np.ones_like(x), x.copy()
    for k in range(2, n + 1):
        pm, p = p, ((2 * k - 1) * x * p - (k - 1) * pm) / k
    return p


def _leg_dP(n: int, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.zeros_like(x)
    out = np.empty_like(x)
    interior = np.abs(x) < 1.0 - 1e-12
    xi = x[interior]
    out[interior] = n * (xi * _leg_P(n, xi) - _leg_P(n - 1, xi)) / (xi * xi - 1.0)
    # Limit at xi = +-1: P'_n(+-1) = (+-1)^{n-1} n(n+1)/2  (FEM.hpp dP boundary case)
    edge = ~interior
    sgn = np.sign(x[edge])
    out[edge] = sgn ** (n - 1) * n * (n + 1) / 2.0
    return out


def _gauss(npts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre rule on [-1,1] (FEM.hpp:73-124 tabulates 1-6 points; the
    tabulated values are the standard nodes, so leggauss is bit-compatible to ~1e-15)."""
    return np.polynomial.legendre.leggauss(npts)


# ---------------------------------------------------------------------------
# Reference-element integral tensors, evaluated with the reference's tensor
# quadrature exactly as LocalMatrices::Compute (FEM.cpp:748-953).
# The physical scalings (Piola factor_d, detJ) separate out, so they are applied
# per element during assembly (identical arithmetic to the C++ inner loops).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ElemTensors:
    dim: int
    k: int
    m: int
    nf: int           # dofs per face = (k+1)^(d-1)
    ni: int           # bubbles per direction = k (k+1)^(d-1)
    n_per_dir: int    # 2 nf + ni
    n_J_loc: int
    n_P_loc: int
    A_geom: np.ndarray   # (dim, n_per_dir, n_per_dir) direction-block of A (no invD/factor)
    B_geom: np.ndarray   # (n_P_loc, n_J_loc) geometry-free divergence pairing
    C_geom: np.ndarray   # (n_P_loc, n_P_loc) reference mass (no Sigma/detJ)


def _face_trans(dim: int, k: int, idx: int) -> Tuple[int, int]:
    """FaceIndexToTransverse (FEM.cpp:362-375)."""
    if dim == 1:
        return 0, 0
    if dim == 2:
        return idx, 0
    return idx % (k + 1), idx // (k + 1)


def _interior_multi(dim: int, k: int, idx: int) -> Tuple[int, int, int]:
    """InteriorIndexToMulti (FEM.cpp:377-398): returns (l, i, j)."""
    if dim == 1:
        return idx, 0, 0
    if dim == 2:
        return idx % k, idx // k, 0
    trans = idx // k
    return idx % k, trans % (k + 1), trans // (k + 1)


def _pk_multi(dim: int, m: int, idx: int) -> Tuple[int, int, int]:
    """PkBasisFunctions::LocalToMultiIndex (FEM.cpp:640-659)."""
    n = m + 1
    if dim == 1:
        return idx, 0, 0
    if dim == 2:
        return idx % n, idx // n, 0
    return idx % n, (idx // n) % n, idx // (n * n)


def _elem_tensors(dim: int, k: int, m: int) -> _ElemTensors:
    nq = 2 * max(k, m) + 3          # quadrature order (NeutFEM.cpp:276-277)
    if nq > 6:
        nq = 5                      # GaussQuadrature1D::get default case (FEM.hpp:116-121)
    pts, wts = _gauss(nq)

    nf = 1 if dim == 1 else (k + 1) if dim == 2 else (k + 1) ** 2
    ni = k if dim == 1 else k * (k + 1) if dim == 2 else k * (k + 1) ** 2
    n_per_dir = 2 * nf + ni
    n_J_loc = dim * n_per_dir
    n_P_loc = (m + 1) ** dim

    # tensor quadrature grid (qx fastest matching loop nesting is irrelevant: sums)
    axes = [pts] * dim + [np.array([0.0])] * (3 - dim)
    waxes = [wts] * dim + [np.array([1.0])] * (3 - dim)
    XI, ETA, ZETA = np.meshgrid(axes[0], axes[1], axes[2], indexing="ij")
    WX, WY, WZ = np.meshgrid(waxes[0], waxes[1], waxes[2], indexing="ij")
    W = (WX * WY * WZ).ravel()      # w_base, no det_J (FEM.cpp:787)
    XI, ETA, ZETA = XI.ravel(), ETA.ravel(), ZETA.ravel()

    def shape_face(coord, is_up):
        return 0.5 * (1.0 + coord) if is_up else 0.5 * (1.0 - coord)

    # Per-direction basis values psi and reference divergences dpsi/dxi_d
    # (RTBasisFunctions::EvalJ*Face/Interior + EvalDivJ*, FEM.cpp:404-620).
    coords = [XI, ETA, ZETA]
    J_vals = np.zeros((dim, n_per_dir, W.size))
    div_vals = np.zeros((dim, n_per_dir, W.size))
    for d in range(dim):
        c = coords[d]
        tr = [coords[a] for a in range(dim) if a != d]  # transverse coords, low axis first
        for f in range(nf):
            i, j = _face_trans(dim, k, f)
            ptr = np.ones_like(W)
            if len(tr) >= 1:
                ptr = ptr * _leg_P(i, tr[0])
            if len(tr) == 2:
                ptr = ptr * _leg_P(j, tr[1])
            J_vals[d, f] = shape_face(c, False) * ptr          # low face
            div_vals[d, f] = -0.5 * ptr
            J_vals[d, nf + f] = shape_face(c, True) * ptr       # high face
            div_vals[d, nf + f] = 0.5 * ptr
        for b in range(ni):
            l, i, j = _interior_multi(dim, k, b)
            ptr = np.ones_like(W)
            if len(tr) >= 1:
                ptr = ptr * _leg_P(i, tr[0])
            if len(tr) == 2:
                ptr = ptr * _leg_P(j, tr[1])
            bub = 1.0 - c * c
            J_vals[d, 2 * nf + b] = bub * _leg_P(l, c) * ptr
            div_vals[d, 2 * nf + b] = (-2.0 * c * _leg_P(l, c) + bub * _leg_dP(l, c)) * ptr

    phi_vals = np.zeros((n_P_loc, W.size))
    for p in range(n_P_loc):
        i, j, kk = _pk_multi(dim, m, p)
        v = _leg_P(i, XI)
        if dim >= 2:
            v = v * _leg_P(j, ETA)
        if dim == 3:
            v = v * _leg_P(kk, ZETA)
        phi_vals[p] = v

    # A per direction-block: sum_q w_base psi_i psi_j      (FEM.cpp:873-921)
    A_geom = np.einsum("diq,djq,q->dij", J_vals, J_vals, W)
    # B: sum_q w_base phi_p dpsi_j (reference divergence)  (FEM.cpp:926-936)
    B_geom = np.zeros((n_P_loc, n_J_loc))
    for d in range(dim):
        B_geom[:, d * n_per_dir:(d + 1) * n_per_dir] = np.einsum(
            "pq,jq,q->pj", phi_vals, div_vals[d], W
        )
    # C: sum_q w_base phi_i phi_j (times Sigma detJ later) (FEM.cpp:938-949)
    C_geom = np.einsum("pq,rq,q->pr", phi_vals, phi_vals, W)

    return _ElemTensors(dim, k, m, nf, ni, n_per_dir, n_J_loc, n_P_loc,
                        A_geom, B_geom, C_geom)


# ---------------------------------------------------------------------------
# FESpace DOF numbering (FEM.cpp:172-334), transcribed.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Space:
    dim: int
    nx: int
    ny: int
    nz: int
    nf: int
    ni: int
    nP: int
    n_Jx: int
    n_Jy: int
    n_Jz: int
    n_J_face: int
    n_J: int
    n_Phi: int

    @property
    def NE(self):
        return self.nx * self.ny * self.nz

    def elem_index(self, ix, iy, iz):
        return iz * self.nx * self.ny + iy * self.nx + ix

    def jx_face(self, ix, iy, iz, f):
        if self.dim == 1:
            return ix * self.nf + f
        if self.dim == 2:
            return (iy * (self.nx + 1) + ix) * self.nf + f
        return (iz * self.ny * (self.nx + 1) + iy * (self.nx + 1) + ix) * self.nf + f

    def jy_face(self, ix, iy, iz, f):
        base = self.n_Jx
        if self.dim == 2:
            return base + (iy * self.nx + ix) * self.nf + f
        return base + (iz * (self.ny + 1) * self.nx + iy * self.nx + ix) * self.nf + f

    def jz_face(self, ix, iy, iz, f):
        base = self.n_Jx + self.n_Jy
        return base + (iz * self.ny * self.nx + iy * self.nx + ix) * self.nf + f

    def j_interior(self, dirn, elem, b):
        base = self.n_J_face + dirn * self.NE * self.ni
        return base + elem * self.ni + b


def _make_space(dim, nx, ny, nz, k, m) -> _Space:
    nf = 1 if dim == 1 else (k + 1) if dim == 2 else (k + 1) ** 2
    ni = k if dim == 1 else k * (k + 1) if dim == 2 else k * (k + 1) ** 2
    nP = (m + 1) ** dim
    if dim == 1:
        n_Jx, n_Jy, n_Jz = (nx + 1) * nf, 0, 0
    elif dim == 2:
        n_Jx, n_Jy, n_Jz = (nx + 1) * ny * nf, nx * (ny + 1) * nf, 0
    else:
        n_Jx = (nx + 1) * ny * nz * nf
        n_Jy = nx * (ny + 1) * nz * nf
        n_Jz = nx * ny * (nz + 1) * nf
    n_J_face = n_Jx + n_Jy + n_Jz
    NE = nx * ny * nz
    n_J = n_J_face + NE * dim * ni
    return _Space(dim, nx, ny, nz, nf, ni, nP, n_Jx, n_Jy, n_Jz, n_J_face, n_J, NE * nP)


def _global_indices(sp_: _Space, ix, iy, iz):
    """LocalMatrices::GetGlobalJIndices / GetGlobalPhiIndices (FEM.cpp:955-1008)."""
    e = sp_.elem_index(ix, iy, iz)
    J = []
    for f in range(sp_.nf):
        J.append(sp_.jx_face(ix, iy, iz, f))
    for f in range(sp_.nf):
        J.append(sp_.jx_face(ix + 1, iy, iz, f))
    for b in range(sp_.ni):
        J.append(sp_.j_interior(0, e, b))
    if sp_.dim >= 2:
        for f in range(sp_.nf):
            J.append(sp_.jy_face(ix, iy, iz, f))
        for f in range(sp_.nf):
            J.append(sp_.jy_face(ix, iy + 1, iz, f))
        for b in range(sp_.ni):
            J.append(sp_.j_interior(1, e, b))
    if sp_.dim == 3:
        for f in range(sp_.nf):
            J.append(sp_.jz_face(ix, iy, iz, f))
        for f in range(sp_.nf):
            J.append(sp_.jz_face(ix, iy, iz + 1, f))
        for b in range(sp_.ni):
            J.append(sp_.j_interior(2, e, b))
    P = [e * sp_.nP + p for p in range(sp_.nP)]
    return np.array(J, dtype=np.int64), np.array(P, dtype=np.int64)


# ---------------------------------------------------------------------------
# Assembly (NeutFEM.cpp:402-457, 1036-1302) + Dirichlet (1328-1489).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplicaProblem:
    ng: int
    space: _Space
    A: list           # per group: csc A_g with Dirichlet applied
    B: sp.csr_matrix
    BT: sp.csr_matrix
    C: list           # per group csr
    M_fiss: list      # per group csr
    M_scatter: dict   # (g_to, g_from) -> csr  (index g*ng+gp in reference)
    vols: np.ndarray  # element volumes
    chi_dof: np.ndarray  # (ng, n_Phi) chi broadcast to flux DOFs (BuildFissionRHS)


def assemble(
    k: int,
    m: int,
    ng: int,
    x_breaks: np.ndarray,
    y_breaks: Optional[np.ndarray],
    z_breaks: Optional[np.ndarray],
    D: np.ndarray,
    SigR: np.ndarray,
    NSF: np.ndarray,
    Chi: np.ndarray,
    SigS: np.ndarray,
    dirichlet: Dict[Tuple[int, bool], bool],
) -> ReplicaProblem:
    """XS arrays shaped (ng, NE) [SigS: (ng_to, ng_from, NE)] in element order
    e = iz*nx*ny + iy*nx + ix (C-flatten of (nz, ny, nx) grids).
    dirichlet[(axis, upper)] = True marks a vacuum (Marshak) boundary."""
    x_breaks = np.asarray(x_breaks, dtype=np.float64)
    dim = 1
    ny = nz = 1
    hy = hz = np.array([2.0])  # so jac = 1 on inactive axes (mesh convention)
    nx = len(x_breaks) - 1
    hx = np.diff(x_breaks)
    if y_breaks is not None and len(y_breaks) > 1:
        dim = 2
        ny = len(y_breaks) - 1
        hy = np.diff(np.asarray(y_breaks, dtype=np.float64))
    if z_breaks is not None and len(z_breaks) > 1:
        dim = 3
        nz = len(z_breaks) - 1
        hz = np.diff(np.asarray(z_breaks, dtype=np.float64))

    et = _elem_tensors(dim, k, m)
    space = _make_space(dim, nx, ny, nz, k, m)
    NE = space.NE

    # per-element geometry (element order: iz slow, iy, ix fast)
    HX = np.tile(hx, ny * nz)
    HY = np.tile(np.repeat(hy[:ny], nx), nz)
    HZ = np.repeat(hz[:nz], nx * ny)
    if dim == 1:
        detJ = HX / 2.0
        factors = [HX / 2.0]
    elif dim == 2:
        detJ = HX * HY / 4.0
        factors = [HY / HX, HX / HY]            # FEM.cpp:804-806
    else:
        detJ = HX * HY * HZ / 8.0
        factors = [2 * HX / (HY * HZ), 2 * HY / (HX * HZ), 2 * HZ / (HX * HY)]

    # global index table per element
    Jidx = np.zeros((NE, et.n_J_loc), dtype=np.int64)
    Pidx = np.zeros((NE, et.n_P_loc), dtype=np.int64)
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                e = space.elem_index(ix, iy, iz)
                Jidx[e], Pidx[e] = _global_indices(space, ix, iy, iz)

    npd = et.n_per_dir

    def _filter(rows, cols, vals):
        keep = np.abs(vals) > 1e-14          # triplet threshold (NeutFEM.cpp:1064)
        return rows[keep], cols[keep], vals[keep]

    # ---- A per group (block per direction) + Dirichlet ----------------------
    A_mats = []
    for g in range(ng):
        invD = 1.0 / D[g]
        rows_l, cols_l, vals_l = [], [], []
        for d in range(dim):
            blk = et.A_geom[d]                     # (npd, npd)
            scale = invD * factors[d]              # (NE,)
            vals = scale[:, None, None] * blk[None]
            jj = Jidx[:, d * npd:(d + 1) * npd]
            rows = np.repeat(jj, npd, axis=1)
            cols = np.tile(jj, (1, npd))
            rows_l.append(rows.ravel())
            cols_l.append(cols.ravel())
            vals_l.append(vals.reshape(NE, -1).ravel())
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate(vals_l)
        rows, cols, vals = _filter(rows, cols, vals)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(space.n_J, space.n_J)).tocsr()

        # Dirichlet: A[dof,dof] += 2 D G_ff (NeutFEM.cpp:1328-1489; the published
        # code multiplies by D despite its own comment saying it should not).
        diag_add = np.zeros(space.n_J)
        kk = k

        def G_ff(f, fa):
            # ComputeBoundaryFaceIntegral (NeutFEM.cpp:1468-1489)
            if dim == 1:
                return 1.0
            if dim == 2:
                a = f
                return 2.0 * (2.0 / (2 * a + 1)) / fa
            a, b = f % (kk + 1), f // (kk + 1)
            return 4.0 * (2.0 / (2 * a + 1)) * (2.0 / (2 * b + 1)) / fa

        for (axis, upper), on in dirichlet.items():
            if not on:
                continue
            if axis == 0:
                for iz in range(nz):
                    for iy in range(ny):
                        e = space.elem_index(nx - 1 if upper else 0, iy, iz)
                        fa = HY[e] * HZ[e] if dim == 3 else (HY[e] if dim == 2 else 1.0)
                        for f in range(space.nf):
                            dof = space.jx_face(nx if upper else 0, iy, iz, f)
                            diag_add[dof] += G_ff(f, fa) * 2.0 * D[g, e]
            elif axis == 1 and dim >= 2:
                for iz in range(nz):
                    for ix in range(nx):
                        e = space.elem_index(ix, ny - 1 if upper else 0, iz)
                        fa = HX[e] * HZ[e] if dim == 3 else HX[e]
                        for f in range(space.nf):
                            dof = space.jy_face(ix, ny if upper else 0, iz, f)
                            diag_add[dof] += G_ff(f, fa) * 2.0 * D[g, e]
            elif axis == 2 and dim == 3:
                for iy in range(ny):
                    for ix in range(nx):
                        e = space.elem_index(ix, iy, nz - 1 if upper else 0)
                        fa = HX[e] * HY[e]
                        for f in range(space.nf):
                            dof = space.jz_face(ix, iy, nz if upper else 0, f)
                            diag_add[dof] += G_ff(f, fa) * 2.0 * D[g, e]
        A = (A + sp.diags(diag_add)).tocsc()
        A_mats.append(A)

    # ---- B (group independent): B_loc[p, j] -> (Pidx[p], Jidx[j]) ------------
    rows = Pidx[:, :, None].repeat(et.n_J_loc, axis=2).ravel()
    cols = Jidx[:, None, :].repeat(et.n_P_loc, axis=1).ravel()
    vals = np.broadcast_to(et.B_geom[None], (NE, et.n_P_loc, et.n_J_loc)).ravel()
    r, c, v = _filter(rows, cols, np.ascontiguousarray(vals))
    B = sp.coo_matrix((v, (r, c)), shape=(space.n_Phi, space.n_J)).tocsr()
    BT = B.T.tocsr()

    # ---- C / fission / scattering (weighted flux mass) -----------------------
    prow = Pidx[:, :, None].repeat(et.n_P_loc, axis=2).ravel()
    pcol = Pidx[:, None, :].repeat(et.n_P_loc, axis=1).ravel()

    def mass_with(coeff_e):
        vals = (coeff_e * detJ)[:, None, None] * et.C_geom[None]
        r, c, v = _filter(prow, pcol, vals.ravel())
        return sp.coo_matrix((v, (r, c)), shape=(space.n_Phi, space.n_Phi)).tocsr()

    C_mats = [mass_with(SigR[g]) for g in range(ng)]
    # P0 fission/scatter are assembled as plain diagonal nsf*V (NeutFEM.cpp:1212-1219);
    # for P>=1 the weighted mass is used.  mass_with reproduces both (P0: C_geom=[[2^d]],
    # detJ = V/2^d, product = V).
    M_fiss = [mass_with(NSF[g]) for g in range(ng)]
    M_scatter = {}
    for g_to in range(ng):
        for g_from in range(ng):
            if g_to == g_from:
                continue
            s = SigS[g_to, g_from]
            if np.abs(s).max() > 1e-14:
                M_scatter[(g_to, g_from)] = mass_with(s)

    vols = HX * HY * HZ / (2.0 ** (3 - dim))  # inactive h=2 divide out
    # chi is constant per element and multiplies every local mode of the (already
    # mass-weighted) fission source (BuildFissionRHS, NeutFEM.cpp:1550-1560).
    chi_dof = np.repeat(Chi, et.n_P_loc, axis=1)
    return ReplicaProblem(ng, space, A_mats, B, BT, C_mats, M_fiss, M_scatter,
                          vols, chi_dof)


# ---------------------------------------------------------------------------
# Implicit-Schur CG (solvers.cpp:577-636) + Chebyshev (solvers.cpp:664-756)
# + power iteration (NeutFEM.cpp:1627-1826).
# ---------------------------------------------------------------------------

class _Chebyshev:
    def __init__(self, nmax=15, sigma=0.98):
        self.nmax, self.sigma, self.it = nmax, sigma, 0
        G = np.arccosh(2.0 / sigma - 1.0)
        self.a = np.zeros(nmax)
        self.b = np.zeros(nmax)
        self.a[1] = 2.0 / (2.0 - sigma)
        for kk in range(2, nmax):
            self.a[kk] = np.cosh((kk - 1) * G) / np.cosh(kk * G)
            self.b[kk] = np.cosh((kk - 2) * G) / np.cosh(kk * G)
        self.p0 = self.p1 = None

    def __call__(self, phi):
        if self.it == self.nmax:
            self.it, self.p0, self.p1 = 0, None, None
        if self.it == 0:
            self.p0 = phi.copy()
            self.it += 1
            return phi
        if self.it == 1:
            self.p1 = self.p0 + self.a[1] * (phi - self.p0)
            self.it += 1
            return self.p1.copy()
        new = (self.p1 + (4.0 / self.sigma) * self.a[self.it] * (phi - self.p1)
               + self.b[self.it] * (self.p1 - self.p0))
        self.p0, self.p1 = self.p1, new
        self.it += 1
        return new.copy()


def _schur_cg(A_lu, B, BT, C, rhs, tol=1e-10, maxiter=1000):
    """Unpreconditioned CG on S = C + B A^-1 B^T, x0 = 0 (solvers.cpp:577-636)."""
    x = np.zeros_like(rhs)
    r = rhs.copy()
    p = r.copy()
    rr = float(r @ r)
    rhs_norm2 = float(rhs @ rhs)
    tol_sq = tol * tol * rhs_norm2
    for _ in range(maxiter):
        Ap = C @ p + B @ A_lu.solve(BT @ p)
        pAp = float(p @ Ap)
        if abs(pAp) < 1e-30:
            break
        alpha = rr / pAp
        x += alpha * p
        r -= alpha * Ap
        rr_new = float(r @ r)
        if rr_new < tol_sq:
            return x
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x


def solve_keff(
    prob: ReplicaProblem,
    tol_keff: float = 1e-7,
    tol_flux: float = 1e-6,
    max_outer: int = 2000,
    cg_tol: float = 1e-10,
    max_inner: int = 5000,
    use_chebyshev: bool = True,
    phi0: Optional[np.ndarray] = None,
    keff0: float = 1.0,
) -> Tuple[float, np.ndarray, int]:
    """Faithful transcription of NeutFEM::SolveKeff's outer loop (NeutFEM.cpp:1694-1802),
    exact-Schur path (the Python-driver default).  Converge tight to get the true
    discrete eigenvalue."""
    ng, nP = prob.ng, prob.space.n_Phi
    A_lu = [spla.splu(A) for A in prob.A]
    phi = np.ones(ng * nP) if phi0 is None else phi0.copy()
    keff = keff0
    accel = _Chebyshev(15, 0.98)

    for it in range(max_outer):
        phi_old = phi.copy()
        total_fiss = np.zeros(nP)
        for g in range(ng):
            total_fiss += prob.M_fiss[g] @ phi[g * nP:(g + 1) * nP]
        prod_old = total_fiss.sum()

        for g in range(ng):
            rhs = (1.0 / keff) * (prob.chi_dof[g] * total_fiss)
            for gp in range(ng):
                if gp == g or (g, gp) not in prob.M_scatter:
                    continue
                rhs = rhs + prob.M_scatter[(g, gp)] @ phi[gp * nP:(gp + 1) * nP]
            phi[g * nP:(g + 1) * nP] = _schur_cg(
                A_lu[g], prob.B, prob.BT, prob.C[g], rhs, tol=cg_tol, maxiter=max_inner
            )

        prod_new = 0.0
        for g in range(ng):
            prod_new += (prob.M_fiss[g] @ phi[g * nP:(g + 1) * nP]).sum()

        keff_new = keff * prod_new / prod_old
        diff_k = abs(keff_new - keff)
        if it >= 1:
            keff = keff_new

        sol_norm = np.linalg.norm(phi)
        diff_flux = np.linalg.norm(phi - phi_old) / sol_norm
        if sol_norm > 1e-14:
            phi /= sol_norm
        if use_chebyshev and it >= 2:
            phi = accel(phi)
        if diff_k < tol_keff and diff_flux < tol_flux:
            return keff, phi, it + 1
    return keff, phi, max_outer


def replica_from_benchmark(run) -> ReplicaProblem:
    """Build the replica problem from a benchmarks.runner.BenchmarkRun (same XS fill,
    same breaks, same BCs) so both solvers see the identical discrete problem."""
    s = run.solver
    mesh = s._mesh
    ng = s.GetNumGroups()
    dim = mesh.dim
    NE = mesh.n_elements

    def flat(a):
        # compat views are (ng[,nz][,ny],nx); element order = C flatten
        return np.asarray(a, dtype=np.float64).reshape(a.shape[0], NE)

    D = flat(s.get_D())
    SigR = flat(s.get_SigR())
    NSF = flat(s.get_NSF())
    Chi = flat(s.get_Chi())
    SigS = np.asarray(s.get_SigS(), dtype=np.float64).reshape(ng, ng, NE)

    from neutfem_jax.bc import BCKind
    from neutfem_jax.mesh import boundary_attribute

    dirichlet = {}
    for axis in range(dim):
        for upper in (False, True):
            attr = boundary_attribute(dim, axis, upper)
            dirichlet[(axis, upper)] = s._bcs.kind(attr) == BCKind.DIRICHLET

    xb = mesh.x_breaks
    yb = mesh.y_breaks if dim >= 2 else None
    zb = mesh.z_breaks if dim == 3 else None
    return assemble(s._rt_order, s._p_order, ng, xb, yb, zb,
                    D, SigR, NSF, Chi, SigS, dirichlet)
