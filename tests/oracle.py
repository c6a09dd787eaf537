"""Independent dense-assembly oracle for the mixed RT_k/P_m discretization.

Deliberately does NOT reuse neutfem_jax's precomputed element tensors: basis functions are
built as numpy ``Polynomial`` objects and all integrals are evaluated by brute-force
tensor Gauss quadrature on each physical element, with the explicit contravariant Piola
map.  This mirrors what the reference's ``LocalMatrices::Compute`` does pointwise
(/root/reference/src/FEM.cpp:748-953) and serves as the ground truth for the stencil
operators.

Global DOF numbering (flat vectors used only for testing):
  phi: elem-major, ``idx = ((iz*ny + iy)*nx + ix) * P + p``
  J:   [d faces | d bubbles] blocks per active direction d in order x, y, z;
       faces: ``((iz*ny + iy)*(n_d+1) + i_face) * T + t`` style (grid-major, t fastest)
       bubbles: ``(elem * nbub + l) * T + t``
"""

from __future__ import annotations

import itertools

import numpy as np
from numpy.polynomial import polynomial as npoly
from numpy.polynomial.legendre import Legendre

from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.fespace import FESpace
from neutfem_jax.mesh import boundary_attribute


def _legendre_poly(n):
    return Legendre.basis(n).convert(kind=np.polynomial.Polynomial)


def _long_polys(k):
    """Longitudinal J functions as Polynomial objects."""
    x = np.polynomial.Polynomial([0.0, 1.0])
    out = [(1 - x) / 2, (1 + x) / 2]
    for l in range(k):
        out.append((1 - x**2) * _legendre_poly(l))
    return out


class DenseOracle:
    def __init__(self, fes: FESpace, ng: int, xs, bcs: BCSpec, marshak_d_factor=False):
        self.fes = fes
        self.ng = ng
        self.xs = xs
        self.bcs = bcs
        self.marshak_d_factor = marshak_d_factor
        mesh = fes.mesh
        self.mesh = mesh
        k, m = fes.k, fes.m
        self.P = fes.P

        # ---- DOF numbering ------------------------------------------------
        self.n_phi = mesh.n_elements * fes.P
        self.face_offsets = {}
        self.bub_offsets = {}
        off = 0
        for di in fes.dirs:
            self.face_offsets[di.d] = off
            off += int(np.prod(di.face_shape)) * di.T
            if fes.et.nbub > 0:
                self.bub_offsets[di.d] = off
                off += mesh.n_elements * fes.et.nbub * di.T
        self.n_J = off

        self._assemble()

    # ---- index helpers ----------------------------------------------------
    def elem_index(self, ix, iy, iz):
        return (iz * self.mesh.ny + iy) * self.mesh.nx + ix

    def phi_index(self, ix, iy, iz, p):
        return self.elem_index(ix, iy, iz) * self.P + p

    def face_index(self, d, fz, fy, fx, t):
        di = next(x for x in self.fes.dirs if x.d == d)
        sz, sy, sx = di.face_shape
        return self.face_offsets[d] + ((fz * sy + fy) * sx + fx) * di.T + t

    def bub_index(self, d, ix, iy, iz, l, t):
        di = next(x for x in self.fes.dirs if x.d == d)
        nb = self.fes.et.nbub
        return self.bub_offsets[d] + (self.elem_index(ix, iy, iz) * nb + l) * di.T + t

    # ---- assembly ----------------------------------------------------------
    def _assemble(self):
        fes, mesh, ng = self.fes, self.mesh, self.ng
        k, m = fes.k, fes.m
        nq = 2 * (k + m) + 6
        xq, wq = np.polynomial.legendre.leggauss(nq)

        U = _long_polys(k)
        Uv = np.array([u(xq) for u in U])          # (nlong, nq)
        dUv = np.array([u.deriv()(xq) for u in U])  # (nlong, nq)
        Pleg = [_legendre_poly(n) for n in range(max(k, m) + 1)]
        Pv = np.array([p(xq) for p in Pleg])        # (nmax+1, nq)
        P_at = {-1.0: np.array([p(-1.0) for p in Pleg]), 1.0: np.array([p(1.0) for p in Pleg])}

        active = [a for a in range(3) if mesh.active(a)]
        h = {0: mesh.hx, 1: mesh.hy, 2: mesh.hz}

        D = np.asarray(self.xs["D"], dtype=np.float64)
        SigR = np.asarray(self.xs["SigR"], dtype=np.float64)

        A = np.zeros((ng, self.n_J, self.n_J))
        B = np.zeros((self.n_phi, self.n_J))
        C = np.zeros((ng, self.n_phi, self.n_phi))

        # flat list of tensor quadrature points (per-axis index arrays, shape (NQ,));
        # inactive axes contribute a single dummy point.  The integrand evaluation
        # below is vectorized over this axis — still brute-force pointwise
        # quadrature of Polynomial-evaluated bases, just accumulated array-wise.
        qi = np.meshgrid(
            *[np.arange(nq) if mesh.active(a) else np.zeros(1, dtype=int) for a in range(3)],
            indexing="ij",
        )
        qi = {a: qi[a].reshape(-1) for a in range(3)}
        NQ = qi[0].size
        wq_flat = np.ones(NQ)
        for a in active:
            wq_flat = wq_flat * wq[qi[a]]

        # local J dofs of an element for direction d: (which_face/bubble, t) ->
        #   ("L"/"R"/l, t, global_index_fn)
        for iz in range(mesh.nz):
            for iy in range(mesh.ny):
                for ix in range(mesh.nx):
                    e = (ix, iy, iz)
                    idx3 = {0: ix, 1: iy, 2: iz}
                    jac = {a: (h[a][idx3[a]] / 2.0 if mesh.active(a) else 1.0) for a in range(3)}
                    detJ = jac[0] * jac[1] * jac[2]
                    w_flat = detJ * wq_flat  # (NQ,)

                    # P_m test-function values at every qpoint: (P, NQ)
                    pmat = np.ones((fes.P, NQ))
                    for a in active:
                        pmat *= Pv[fes.modes[:, a][:, None], qi[a][None, :]]
                    gp0 = self.phi_index(ix, iy, iz, 0)

                    for d_dir in active:
                        di = next(x for x in fes.dirs if x.d == d_dir)
                        tr_axes = [a for a in active if a != d_dir]
                        s = jac[d_dir] / detJ  # Piola component scale

                        # local J dof list: (kind, i_long, t, gidx)
                        loc = []
                        for t in range(di.T):
                            loc.append((0, t, self.face_index(d_dir, iz, iy, ix, t)))
                        for t in range(di.T):
                            up = [iz, iy, ix]
                            up[2 - d_dir] += 1  # face grid axis: x->last
                            loc.append((1, t, self.face_index(d_dir, up[0], up[1], up[2], t)))
                        for l in range(fes.et.nbub):
                            for t in range(di.T):
                                loc.append((2 + l, t, self.bub_index(d_dir, ix, iy, iz, l, t)))

                        def t_decode(t):
                            # first transverse axis fastest, matching fespace
                            out = {}
                            tt = t
                            for a in tr_axes:
                                out[a] = tt % (k + 1)
                                tt //= k + 1
                            return out

                        ilong_arr = np.array([j[0] for j in loc])
                        t_arr = np.array([j[1] for j in loc])
                        g_arr = np.array([j[2] for j in loc])

                        # transverse tensor values per loc entry: (nloc, NQ)
                        tv = np.ones((len(loc), NQ))
                        for a in tr_axes:
                            tdec_a = np.array([t_decode(t)[a] for t in t_arr])
                            tv *= Pv[tdec_a[:, None], qi[a][None, :]]
                        vals = s * Uv[ilong_arr[:, None], qi[d_dir][None, :]] * tv
                        divs = s * dUv[ilong_arr[:, None], qi[d_dir][None, :]] * tv / jac[d_dir]

                        blockA = (vals * w_flat) @ vals.T  # (nloc, nloc)
                        for g in range(ng):
                            invD = 1.0 / D[g, iz, iy, ix]
                            A[g][np.ix_(g_arr, g_arr)] += invD * blockA
                        # B rows: <P_p, div psi_j>
                        B[gp0 : gp0 + fes.P][:, g_arr] += (pmat * w_flat) @ divs.T

                    # C block (direction-independent)
                    blockC = (pmat * w_flat) @ pmat.T
                    for g in range(ng):
                        C[g, gp0 : gp0 + fes.P, gp0 : gp0 + fes.P] += (
                            SigR[g, iz, iy, ix] * blockC
                        )

        # ---- boundary conditions -------------------------------------------
        self.pinned = np.zeros(self.n_J, dtype=bool)
        for d_dir in active:
            di = next(x for x in fes.dirs if x.d == d_dir)
            tr_axes = [a for a in active if a != d_dir]
            n_d = {0: mesh.nx, 1: mesh.ny, 2: mesh.nz}[d_dir]
            for upper in (False, True):
                attr = boundary_attribute(mesh.dim, d_dir, upper)
                kind = self.bcs.kind(attr)
                if kind == BCKind.NONE:
                    continue
                # iterate boundary faces
                ranges = {a: range({0: mesh.nx, 1: mesh.ny, 2: mesh.nz}[a]) for a in tr_axes}
                for combo in itertools.product(*[ranges[a] for a in tr_axes]):
                    pos = {a: c for a, c in zip(tr_axes, combo)}
                    pos[d_dir] = n_d if upper else 0
                    e_pos = dict(pos)
                    e_pos[d_dir] = n_d - 1 if upper else 0
                    full = {0: 0, 1: 0, 2: 0}
                    full.update(pos)
                    e_full = {0: 0, 1: 0, 2: 0}
                    e_full.update(e_pos)
                    jac = {
                        a: (h[a][e_full[a]] / 2.0 if mesh.active(a) else 1.0) for a in range(3)
                    }
                    detJ = jac[0] * jac[1] * jac[2]
                    s = jac[d_dir] / detJ
                    fa_ref_scale = 1.0
                    for a in tr_axes:
                        fa_ref_scale *= jac[a]  # transverse surface measure scale
                    for t in range(di.T):
                        gidx = self.face_index(d_dir, full[2], full[1], full[0], t)
                        if kind in (BCKind.MIRROR, BCKind.NEUMANN):
                            self.pinned[gidx] = True
                        elif kind in (BCKind.DIRICHLET, BCKind.ROBIN):
                            # int_face (psi.n)^2 dS by transverse quadrature
                            tdec = {}
                            tt = t
                            for a in tr_axes:
                                tdec[a] = tt % (k + 1)
                                tt //= k + 1
                            G = 0.0
                            for q_ids in itertools.product(
                                *[range(nq) if a in tr_axes else [0] for a in range(3)]
                            ):
                                w = fa_ref_scale
                                tv = 1.0
                                for a in tr_axes:
                                    w *= wq[q_ids[a]]
                                    tv *= Pv[tdec[a], q_ids[a]]
                                G += (s * tv) ** 2 * w
                            for g in range(ng):
                                if kind == BCKind.DIRICHLET:
                                    c = 2.0
                                    if self.marshak_d_factor:
                                        c *= D[g, e_full[2], e_full[1], e_full[0]]
                                else:
                                    c = self.bcs.robin_beta / (
                                        self.bcs.robin_alpha * D[g, e_full[2], e_full[1], e_full[0]]
                                    )
                                A[g, gidx, gidx] += c * G

        # apply pinning: identity rows/cols in A, zero B columns
        for idx in np.where(self.pinned)[0]:
            A[:, idx, :] = 0.0
            A[:, :, idx] = 0.0
            A[:, idx, idx] = 1.0
            B[:, idx] = 0.0

        self.A = A
        self.B = B
        self.C = C

    def schur(self, g: int) -> np.ndarray:
        Ainv = np.linalg.inv(self.A[g])
        return self.C[g] + self.B @ Ainv @ self.B.T

    # ---- state <-> flat converters -----------------------------------------
    def phi_to_flat(self, phi_g: np.ndarray) -> np.ndarray:
        """phi_g: (nz, ny, nx, P) -> flat (n_phi,)."""
        return np.asarray(phi_g).reshape(-1)

    def flat_to_phi(self, v: np.ndarray) -> np.ndarray:
        m = self.mesh
        return np.asarray(v).reshape(m.nz, m.ny, m.nx, self.fes.P)

    def J_to_flat(self, J_g) -> np.ndarray:
        """J_g: dict {f"d{d}": (faces (..., T), bubbles or None)} -> flat (n_J,)."""
        out = np.zeros(self.n_J)
        for di in self.fes.dirs:
            F, W = J_g[f"d{di.d}"]
            o = self.face_offsets[di.d]
            out[o : o + F.size] = np.asarray(F).reshape(-1)
            if W is not None:
                ob = self.bub_offsets[di.d]
                out[ob : ob + W.size] = np.asarray(W).reshape(-1)
        return out

    def flat_to_J(self, v: np.ndarray):
        out = {}
        for di in self.fes.dirs:
            o = self.face_offsets[di.d]
            nF = int(np.prod(di.face_shape)) * di.T
            F = np.asarray(v[o : o + nF]).reshape(*di.face_shape, di.T)
            W = None
            if self.fes.et.nbub > 0:
                ob = self.bub_offsets[di.d]
                nW = self.mesh.n_elements * self.fes.et.nbub * di.T
                W = np.asarray(v[ob : ob + nW]).reshape(
                    *self.mesh.shape, self.fes.et.nbub, di.T
                )
            out[f"d{di.d}"] = (F, W)
        return out
