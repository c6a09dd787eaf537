"""Reference-compatible ``neutfem._neutfem_eigen`` module.

Pure-Python re-creation of the pybind11 surface of the reference build
(``/root/reference/src/wrapper.cpp``): the four enums and the ``NeutFEM`` class with
its ~35 methods, backed by the solver layers in ``neutfem_jax``.  Benchmark
drivers written against the C++ module run unmodified.

Deliberate differences from the reference (SURVEY.md §7.4 — holes filled, not copied):

* ``apply_quarter_rotational_symmetry`` and ``apply_central_symmetry`` are bound (every
  reference benchmark driver calls them, but the reference wrapper only binds
  ``apply_quarter_symmetry`` — wrapper.cpp:518 — so those scripts crash on the original).
* ``SolveSubcritical``, ``project_flux``, ``project_power``, ``zoom_resolved`` are
  implemented (declared + bound but never implemented in the reference — NeutFEM.hpp:279,
  303-312; behavior follows their docstrings, wrapper.cpp:700-715, 1005-1064).
* MIRROR/NEUMANN(0)/ROBIN boundary conditions actually work (the reference's
  ``ApplyBoundaryConditions`` is an empty stub, NeutFEM.cpp:2128-2131).
* The Marshak (DIRICHLET) boundary term uses the reference's exact ``2*D*G_ff``
  convention (NeutFEM.cpp:1350) for eigenvalue parity.
"""

from __future__ import annotations

import enum
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from neutfem_jax import config
from neutfem_jax.bc import BCKind, BCSpec
from neutfem_jax.coarse import coarse_init, coarsen_xs
from neutfem_jax.fespace import FESpace, make_fespace
from neutfem_jax.mesh import CartesianMesh, best_axis_order, boundary_attribute
from neutfem_jax.ops.context import build_context
from neutfem_jax.power import (
    SolveOptions,
    biorthogonal_inner,
    compute_current,
    fixed_source_solve,
    power_iteration,
    solve_subcritical,
)

from .vtk import write_vtk

__all__ = ["NeutFEM", "BCType", "BoundaryID", "LinearSolverType", "VerbosityLevel"]


# ---------------------------------------------------------------------------
# Enums — names and values of the reference (NeutFEM.hpp:51-91, solvers.hpp:176-190)
# ---------------------------------------------------------------------------

class BCType(enum.IntEnum):
    DIRICHLET = 0
    NEUMANN = 1
    MIRROR = 2
    ROBIN = 3
    PERIODIC = 4


class VerbosityLevel(enum.IntEnum):
    SILENT = 0
    LIGHT = 1  # exists in C++ but was not bound by the reference wrapper
    NORMAL = 2
    VERBOSE = 3
    DEBUG = 4


class BoundaryID(enum.IntEnum):
    # aliased values exactly as the reference header (NeutFEM.hpp:73-91)
    LEFT_1D = 1
    RIGHT_1D = 2
    LEFT_2D = 1
    RIGHT_2D = 2
    TOP_2D = 3
    BOTTOM_2D = 4
    BACK_3D = 1
    FRONT_3D = 2
    LEFT_3D = 3
    RIGHT_3D = 4
    TOP_3D = 5
    BOTTOM_3D = 6


class LinearSolverType(enum.IntEnum):
    DIRECT_LU = 0
    DIRECT_LDLT = 1
    DIRECT_LLT = 2
    CG = 3
    CG_DIAG = 4
    CG_ICHOL = 5
    BICGSTAB = 6
    BICGSTAB_DIAG = 7
    BICGSTAB_ILU = 8
    LCG = 9


_SOLVER_NAMES = {
    LinearSolverType.DIRECT_LU: "SparseLU",
    LinearSolverType.DIRECT_LDLT: "SimplicialLDLT",
    LinearSolverType.DIRECT_LLT: "SimplicialLLT",
    LinearSolverType.CG: "ConjugateGradient",
    LinearSolverType.CG_DIAG: "ConjugateGradient+Diagonal",
    LinearSolverType.CG_ICHOL: "ConjugateGradient+IncompleteCholesky",
    LinearSolverType.BICGSTAB: "BiCGSTAB",
    LinearSolverType.BICGSTAB_DIAG: "BiCGSTAB+Diagonal",
    LinearSolverType.BICGSTAB_ILU: "BiCGSTAB+ILUT",
    LinearSolverType.LCG: "LeastSquaresConjugateGradient",
}

# Every iterative variant maps onto the equilibrated CG kernel: the Schur
# complement is SPD, for which CG is optimal.  The BiCGSTAB kernel exists in
# neutfem_jax.krylov for non-symmetric operators, but is NOT used here: its
# unsymmetric recurrences overflow in float32 on problems with ~1e15 void
# absorbers (IAEA-3D filler cells), while CG with symmetric Jacobi
# equilibration is robust.  The DIRECT_* variants take the explicit-Schur path
# (dense S via vmapped matvec + equilibrated Cholesky, ops/direct.py — the
# analogue of the reference's explicit path, solvers.cpp:259-427), gated to
# n_phi <= NEUTFEM_DIRECT_MAX_NPHI with a loud CG fallback above it (there is no
# scalable sparse-LU analogue in this matrix-free design).
_SOLVER_KIND = {t: "cg" for t in LinearSolverType}
for _t in (LinearSolverType.DIRECT_LU, LinearSolverType.DIRECT_LDLT,
           LinearSolverType.DIRECT_LLT):
    _SOLVER_KIND[_t] = "direct"


def _subcell_average_matrix(order: int, r: int) -> np.ndarray:
    """T[s, n] = average of Legendre P_n over subcell s of [-1,1] split into r parts,
    via the antiderivative identity (2n+1) ∫ P_n = P_{n+1} - P_{n-1}."""
    from neutfem_jax.elements import legendre_table

    edges = np.linspace(-1.0, 1.0, r + 1)
    Pe = legendre_table(order + 1, edges)  # (order+2, r+1)
    T = np.zeros((r, order + 1))
    width = 2.0 / r
    for n in range(order + 1):
        if n == 0:
            prim = edges.copy()
        else:
            prim = (Pe[n + 1] - Pe[n - 1]) / (2 * n + 1)
        T[:, n] = (prim[1:] - prim[:-1]) / width
    return T


# The axis-order choice lives in the core (neutfem_jax.mesh) so core-API users
# can relabel their own problems; the compat layer applies it below (__init__).
_choose_axis_perm = best_axis_order


class NeutFEM:
    """Reference-compatible solver facade (wrapper.cpp:274-1065)."""

    # -- construction -------------------------------------------------------

    def __init__(self, *args, **kwargs):
        # Both pybind overloads, positionally or by keyword (README.md:186-190 uses
        # NeutFEM(order=0, ng=2, x_breaks=..., y_breaks=..., z_breaks=...)).
        if kwargs:
            if "order" in kwargs or (len(args) + len(kwargs) == 5):
                names = ["order", "ng", "x_breaks", "y_breaks", "z_breaks"]
            else:
                names = ["rt_order", "p_order", "ng", "x_breaks", "y_breaks", "z_breaks"]
            vals = dict(zip(names, args))
            vals.update(kwargs)
            missing = [n for n in names if n not in vals]
            if missing:
                raise TypeError(f"NeutFEM: missing arguments {missing}")
            args = tuple(vals[n] for n in names)
        if len(args) == 5:
            rt_order, ng, xb, yb, zb = args
            p_order = rt_order
        elif len(args) == 6:
            rt_order, p_order, ng, xb, yb, zb = args
        else:
            raise TypeError(
                "NeutFEM(order, ng, x_breaks, y_breaks, z_breaks) or "
                "NeutFEM(rt_order, p_order, ng, x_breaks, y_breaks, z_breaks)"
            )
        rt_order, p_order, ng = int(rt_order), int(p_order), int(ng)
        if p_order > rt_order:
            p_order = rt_order  # inf-sup guard (NeutFEM.cpp:149-169)

        self._mesh = CartesianMesh.from_breaks(xb, yb, zb)
        # Internal axis orientation: the solver treats x/y/z symmetrically, so
        # it may solve an axis-RELABELED problem and convert at every IO
        # boundary.  self._axperm[c] = the user cartesian axis (0=x,1=y,2=z)
        # that internal cartesian axis c takes (mesh.best_axis_order: the
        # identity; the tests drive other permutations).  The user-facing surface
        # (XS views, flux getters, VTK, checkpoints, projections) stays in user
        # orientation.
        self._axperm = _choose_axis_perm(self._mesh)
        if self._axperm != (0, 1, 2):
            ub = {0: xb, 1: yb, 2: zb}
            self._imesh = CartesianMesh.from_breaks(
                ub[self._axperm[0]], ub[self._axperm[1]], ub[self._axperm[2]])
        else:
            self._imesh = self._mesh
        self._fes: FESpace = make_fespace(self._imesh, rt_order, p_order)
        # Flux-mode gather for P > 1 under a non-identity perm: user mode q's
        # coefficient lives at internal mode index _mode_gather[q] (exponent
        # tuples permuted; the mode LIST itself is perm-invariant because the
        # active axes keep the same order set).
        self._mode_gather = None
        if self._axperm != (0, 1, 2) and self._fes.P > 1:
            M = self._fes.modes
            idx = {tuple(int(v) for v in M[i]): i for i in range(self._fes.P)}
            p = self._axperm
            self._mode_gather = np.array(
                [idx[tuple(int(M[q][p[c]]) for c in range(3))]
                 for q in range(self._fes.P)], dtype=np.int64)
        self._ng = ng
        self._rt_order = rt_order
        self._p_order = p_order
        self._dtype = config.real_dtype

        sh = (ng, *self._mesh.shape)
        # XS storage with the reference defaults (NeutFEM.cpp:179-218)
        self._xs: Dict[str, np.ndarray] = {
            "D": np.full(sh, 1.0),
            "SRC": np.zeros(sh),
            "SigR": np.full(sh, 0.01),
            "NSF": np.zeros(sh),
            "KSF": np.zeros(sh),
            "Chi": np.zeros(sh),
            "SigS": np.zeros((ng, ng, *self._mesh.shape)),
        }
        self._xs["Chi"][0] = 1.0

        self._bcs = BCSpec()
        self._solver_type = LinearSolverType.BICGSTAB  # reference default (NeutFEM.cpp:126)
        self._resolved_solver_kind = None  # per-solve cache (see _inner_solver)
        self._tol_keff = 1e-5
        self._tol_flux = 1e-5
        self._tol_l2 = 1e-5
        self._max_outer = 200
        self._max_inner = 1000
        self._verbosity = VerbosityLevel.NORMAL
        self._cmfd_omega = 1.0
        self._accel = "chebyshev"  # reference hardwires Chebyshev (NeutFEM.cpp:1673)

        self._ctx_cache: Dict[str, Dict] = {}
        self._fn_cache: Dict = {}
        self._built = False
        self._phi: Optional[jnp.ndarray] = None      # (ng, nz, ny, nx, P)
        self._phi_adj: Optional[jnp.ndarray] = None
        self._J = None
        self._J_adj = None
        self._keff: Optional[float] = None
        self._keff_adj: Optional[float] = None
        self._sym_flags: List[str] = []

        self._log(
            VerbosityLevel.NORMAL,
            f"NeutFEM RT{rt_order}-P{p_order}: {self._mesh.dim}D mesh "
            f"{self._mesh.nx}x{self._mesh.ny}x{self._mesh.nz}, {ng} groups, "
            f"{self._fes.n_phi} flux DOFs, {self._fes.n_J} current DOFs [{jax.default_backend()} backend]",
        )

    # -- small utilities ----------------------------------------------------

    def _log(self, level: VerbosityLevel, *msg):
        if self._verbosity >= level:
            print(*msg)

    def _squeeze(self, arr: np.ndarray) -> np.ndarray:
        """Return the dimension-appropriate mutable view: (ng[,nz][,ny],nx)
        (reference zero-copy layout, NeutFEM.cpp:2626-2644)."""
        if self._mesh.dim == 3:
            return arr
        if self._mesh.dim == 2:
            return arr[..., 0, :, :]
        return arr[..., 0, 0, :]

    # -- internal axis orientation (see __init__) -----------------------------

    def _perm_axes(self, ndim: int, tail: int, inverse: bool) -> list:
        """Transpose spec for the last-3 spatial axes (at offset ``tail`` from the
        end) between user and internal orientation.  Cartesian axis c (0=x,1=y,
        2=z) sits at array position ndim-1-tail-c."""
        p = self._axperm
        axes = list(range(ndim))
        base = ndim - 1 - tail
        if not inverse:  # user -> internal: internal cart c takes user cart p[c]
            for c in range(3):
                axes[base - c] = base - p[c]
        else:
            for c in range(3):
                axes[base - p[c]] = base - c
        return axes

    def _to_internal(self, a, tail: int = 0):
        if a is None or self._axperm == (0, 1, 2):
            return a
        a = np.asarray(a)
        return np.transpose(a, self._perm_axes(a.ndim, tail, False))

    def _to_user(self, a, tail: int = 0):
        if a is None or self._axperm == (0, 1, 2):
            return a
        a = np.asarray(a)
        return np.transpose(a, self._perm_axes(a.ndim, tail, True))

    def _phi_to_user(self, phi):
        """Internal flux (ng, nz', ny', nx', P) -> user orientation + mode order."""
        if phi is None or self._axperm == (0, 1, 2):
            return None if phi is None else np.asarray(phi)
        out = self._to_user(phi, tail=1)
        if self._mode_gather is not None:
            out = out[..., self._mode_gather]
        return out

    def _phi_from_user(self, phi):
        if phi is None or self._axperm == (0, 1, 2):
            return phi
        a = np.asarray(phi)
        if self._mode_gather is not None:
            a = a[..., np.argsort(self._mode_gather)]
        return self._to_internal(a, tail=1)

    def _ixs(self) -> Dict[str, np.ndarray]:
        """XS dict in internal orientation (the user views stay user-oriented)."""
        if self._axperm == (0, 1, 2):
            return self._xs
        return {k: self._to_internal(v) for k, v in self._xs.items()}

    def _ibcs(self) -> BCSpec:
        """BCSpec with boundary attributes remapped to internal axes."""
        if self._axperm == (0, 1, 2):
            return self._bcs
        b = BCSpec(robin_alpha=self._bcs.robin_alpha,
                   robin_beta=self._bcs.robin_beta)
        dim = self._mesh.dim
        for c in range(dim):
            for upper in (False, True):
                a_user = boundary_attribute(dim, self._axperm[c], upper)
                if a_user in self._bcs.kinds:
                    a_int = boundary_attribute(dim, c, upper)
                    b.kinds[a_int] = self._bcs.kinds[a_user]
                    b.values[a_int] = self._bcs.values[a_user]
        return b

    def _ifactors(self, factors: Sequence[int]):
        """Per-axis (x, y, z) refine/coarsen factors, user -> internal order."""
        f = [int(v) for v in factors] + [1] * max(0, 3 - len(factors))
        return tuple(f[self._axperm[c]] for c in range(3))

    def _ctx(self, a_mode: str):
        if not self._built:
            raise RuntimeError("BuildMatrices() must be called before solving")
        if a_mode not in self._ctx_cache:
            self._ctx_cache[a_mode] = build_context(
                self._fes, self._ng, self._ixs(), self._ibcs(),
                a_mode=a_mode, dtype=self._dtype, marshak_d_factor=True,
            )
        ctx = self._ctx_cache[a_mode]
        precond_env = os.environ.get("NEUTFEM_PRECOND", "auto")
        want_tg = precond_env == "twogrid"
        if not want_tg and precond_env == "auto" and self._fes.P == 1:
            # auto rule: attach the dense coarse correction on fine 2D meshes,
            # where it cuts inners/outer roughly in half (twogrid.auto_twogrid);
            # power.py resolves "auto" to twogrid iff the context carries it
            from neutfem_jax.twogrid import auto_twogrid

            want_tg = auto_twogrid(self._fes.mesh)
        if want_tg and "tg" not in ctx and a_mode == "exact":
            from neutfem_jax.twogrid import DENSE_MAX_NC, attach_twogrid

            self._log(VerbosityLevel.VERBOSE, "Building two-grid coarse context")
            attach_twogrid(self._fes, self._ng, self._ixs(), self._ibcs(), ctx,
                           dtype=self._dtype, marshak_d_factor=True,
                           # dense precomputed coarse inverse by default;
                           # NEUTFEM_TG_MODE=cheby selects the polynomial form
                           mode=os.environ.get("NEUTFEM_TG_MODE", "dense"),
                           dense_max=int(os.environ.get(
                               "NEUTFEM_TG_DENSE_MAX", DENSE_MAX_NC)))
        if self._inner_solver() == "direct" and "schur_chol" not in ctx:
            from neutfem_jax.ops.direct import attach_dense_schur

            self._log(VerbosityLevel.VERBOSE,
                      f"Building explicit Schur factors (n_phi={self._fes.n_phi})")
            attach_dense_schur(self._fes, ctx, a_mode)
        return ctx

    def _inner_solver(self) -> str:
        """Resolve the LinearSolverType to an inner-solver kind, applying the
        dense-direct size gate (reference explicit-Schur path, solvers.cpp:114-124).

        The resolution is cached until the next solve entry / set_linear_solver so
        that _ctx (which attaches dense factors) and _opts (which selects the
        solver) always agree even if NEUTFEM_DIRECT_MAX_NPHI changes mid-solve
        (round-2 ADVICE: a disagreement would KeyError on schur_chol inside jit)."""
        if self._resolved_solver_kind is not None:
            return self._resolved_solver_kind
        kind = _SOLVER_KIND[self._solver_type]
        if kind == "direct":
            from neutfem_jax.ops.direct import DIRECT_MAX_NPHI

            gate = int(os.environ.get("NEUTFEM_DIRECT_MAX_NPHI", DIRECT_MAX_NPHI))
            if self._fes.n_phi > gate:
                warnings.warn(
                    f"{_SOLVER_NAMES[self._solver_type]}: dense explicit-Schur is "
                    f"gated to n_phi <= {gate} (have {self._fes.n_phi}); falling "
                    "back to the equilibrated Schur-CG (raise "
                    "NEUTFEM_DIRECT_MAX_NPHI to override)",
                    RuntimeWarning,
                )
                kind = "cg"
        self._resolved_solver_kind = kind
        return kind

    def _opts(self, a_mode: str, use_cmfd: bool = False,
              diag_elementwise: bool = False) -> SolveOptions:
        return SolveOptions(
            tol_keff=self._tol_keff,
            tol_flux=self._tol_flux,
            # the reference wires tol_flux (not tol_L2) into the Schur solver
            # (NeutFEM.cpp:334); tol_L2 is stored but never used there
            inner_tol=self._tol_flux,
            max_outer=self._max_outer,
            max_inner=self._max_inner,
            accel=self._accel,
            a_mode=a_mode,
            inner_solver=self._inner_solver(),
            use_cmfd=use_cmfd,
            cmfd_omega=self._cmfd_omega,
            diag_elementwise=diag_elementwise,
            # Schur CG preconditioner ("auto" | "jacobi" | "line" | "line2");
            # env knob for experiments — see power.SolveOptions.inner_precond
            inner_precond=os.environ.get("NEUTFEM_PRECOND", "auto"),
            # two-grid knobs (only read when inner_precond == "twogrid")
            tg_degree=int(os.environ.get("NEUTFEM_TG_DEGREE", "8")),
            tg_kappa=float(os.environ.get("NEUTFEM_TG_KAPPA", "30.0")),
            # branch-free Chebyshev blend (NEUTFEM_CHEBBLEND=0 reverts to the
            # lax.cond+switch form for A/B)
            cheby_blend=os.environ.get("NEUTFEM_CHEBBLEND", "1") != "0",
            # Adaptive inner-tolerance schedule (Eisenstat-Walker style): each
            # outer's Schur CG stops at clip(eta*dphi_prev, inner_tol, 0.1), and
            # convergence is only certified by an endgame-tolerance outer (see
            # power.SolveOptions.inner_eta).  Default ON at eta=0.03, which
            # keeps the outer counts of the fixed tolerance and shifts k by
            # less than tol_keff.  NEUTFEM_INNER_ETA=0 restores the
            # reference's fixed tolerance.
            inner_eta=float(os.environ.get("NEUTFEM_INNER_ETA", "0.03")),
            # reference per-iteration console line every 5 outers (NeutFEM.cpp:1791)
            log_every=5 if self._verbosity >= VerbosityLevel.VERBOSE else 0,
        )

    def _solver_fn(self, opts: SolveOptions, adjoint: bool, hold_keff: bool):
        """Jitted power-iteration kernel; cached per static configuration on THIS
        instance (a module-level lru_cache on the bound method would pin every
        solver instance + its executables for process lifetime).  With hold_keff
        the eigenvalue stays at keff0 (its value is traced, so changing the direct
        k between adjoint solves does not retrace)."""
        key = (opts, adjoint, hold_keff)
        fn = self._fn_cache.get(key)
        if fn is not None:
            return fn
        fes, ng = self._fes, self._ng

        def run(ctx, phi0, keff0):
            return power_iteration(fes, ng, opts, ctx, phi0, keff0, adjoint=adjoint,
                                   fixed_keff=(keff0 if hold_keff else None))

        fn = jax.jit(run)
        self._fn_cache[key] = fn
        return fn

    def __hash__(self):  # needed for the lru_cache on methods
        return id(self)

    def __eq__(self, other):
        return self is other

    def _flat_phi(self):
        # internal orientation (feeds the solver; constant, so no conversion)
        return jnp.ones((self._ng, *self._imesh.shape, self._fes.P), dtype=self._dtype)

    # -- configuration (wrapper.cpp:401-571) ---------------------------------

    def set_bc(self, attr: int, bc_type, value: float = 0.0):
        self._bcs.set(int(attr), BCKind(int(bc_type)), float(value))
        self._ctx_cache.clear()

    def set_robin_coefficients(self, alpha: float, beta: float):
        self._bcs.robin_alpha = float(alpha)
        self._bcs.robin_beta = float(beta)
        self._ctx_cache.clear()

    def set_linear_solver(self, solver_type):
        self._solver_type = LinearSolverType(int(solver_type))
        self._resolved_solver_kind = None

    def set_tol(self, tol_keff=1e-5, tol_flux=1e-5, tol_L2=1e-5, max_outer=200,
                max_inner=1000):
        self._tol_keff = float(tol_keff)
        self._tol_flux = float(tol_flux)
        self._tol_l2 = float(tol_L2)
        self._max_outer = int(max_outer)
        self._max_inner = int(max_inner)

    def set_verbosity(self, level):
        self._verbosity = VerbosityLevel(int(level))

    def set_cmfd_relaxation(self, omega: float):
        self._cmfd_omega = float(omega)

    def set_acceleration(self, kind: str):
        """Extension beyond the reference wrapper: choose the outer-iteration
        accelerator ("chebyshev" — the reference's hardwired choice — "anderson",
        or "none").  Anderson is advertised by the reference but shipped as dead
        code (solvers.cpp:772-891); here it is first-class."""
        kind = str(kind).lower()
        if kind not in ("chebyshev", "anderson", "none"):
            raise ValueError(f"unknown acceleration {kind!r}")
        self._accel = kind

    def apply_quarter_symmetry(self, axis1: int = 0, axis2: int = 1):
        """Reference behavior (NeutFEM.cpp:356-362): set MIRROR on the two cut planes
        of a quarter core and record the flag (drivers then override BCs explicitly)."""
        self._bcs.set(int(BoundaryID.LEFT_2D), BCKind.MIRROR)
        self._bcs.set(int(BoundaryID.BOTTOM_2D), BCKind.MIRROR)
        self._sym_flags.append(f"quarter({axis1},{axis2})")
        self._ctx_cache.clear()

    # Names used by every reference benchmark driver but missing from the reference
    # wrapper (SURVEY §2.4 API drift) — bound here so the scripts run unmodified.
    def apply_quarter_rotational_symmetry(self, axis1: int = 0, axis2: int = 1):
        self.apply_quarter_symmetry(axis1, axis2)

    def apply_central_symmetry(self, axis1: int = 0, axis2: int = 1):
        self._sym_flags.append(f"central({axis1},{axis2})")

    # Reflector API: no-op stubs exactly like the reference (NeutFEM.cpp:2614-2620)
    def add_refl(self, *args, **kwargs):
        return None

    def set_refl(self, *args, **kwargs):
        return None

    def clean_refl(self, *args, **kwargs):
        return None

    # -- observability / health (SURVEY §5 aux subsystems) --------------------

    def _maybe_profile(self, label: str):
        """jax.profiler trace around a solve when NEUTFEM_PROFILE=<dir> is set
        (the analogue of the reference's chrono spans, NeutFEM.cpp:1688)."""
        import contextlib
        import os

        trace_dir = os.environ.get("NEUTFEM_PROFILE")
        if not trace_dir:
            return contextlib.nullcontext()
        return jax.profiler.trace(trace_dir)

    def _check_health(self, keff: float, finite, what: str):
        """Numerical guard: the reference throws on singular factorizations
        (solvers.cpp:164-167); here divergence shows up as non-finite or absurd
        results — warn loudly instead of returning garbage.  ``finite`` is either
        a bool (precomputed on device inside the solve) or a flux array."""
        import warnings

        if not isinstance(finite, (bool, np.bool_)):
            finite = bool(jnp.isfinite(finite).all())
        finite = finite and np.isfinite(keff)
        if not finite:
            warnings.warn(
                f"{what} produced non-finite results (keff={keff}); the system may "
                "be ill-posed (e.g. supercritical fixed-source problem) or the "
                "tolerances too loose", RuntimeWarning, stacklevel=3,
            )
        elif keff < 0.5 or keff > 2.0:
            # On any reactor-physics problem k outside [0.5, 2.0] is already
            # implausible: the reference's own broken diagonal-Schur scheme returned
            # k ~ 0.04 silently — a guard at (0, 10] never fires (VERDICT round 1).
            warnings.warn(
                f"{what} converged to an implausible eigenvalue keff={keff:.6g} "
                "(outside [0.5, 2.0]); check cross-sections, boundary conditions "
                "and solver flags",
                RuntimeWarning, stacklevel=3,
            )

    _SCALAR_KEYS = ("keff", "outer_iterations", "inner_iterations",
                    "last_inner_iterations", "last_inner_residual",
                    "diff_k", "diff_flux", "history", "finite")

    @classmethod
    def _fetch_scalars(cls, res) -> dict:
        """All post-solve diagnostics in ONE device->host transfer (one
        synchronisation instead of one per scalar)."""
        return jax.device_get({k: res[k] for k in cls._SCALAR_KEYS if k in res})

    def _store_history(self, host, opts) -> None:
        """Keep the per-outer (k, dk, dphi, inner iters) table (at VERBOSE the
        reference's console lines are printed live from the loop,
        opts.log_every)."""
        hist = host.get("history")
        if hist is None:
            return
        n = int(host["outer_iterations"])
        self._last_history = np.asarray(hist)[:n]

    def get_iteration_history(self) -> np.ndarray:
        """(n_outer, 4) array of per-outer-iteration [k, dk, dphi, inner iters]
        from the last SolveKeff/SolveAdjoint (empty before any solve).  New scope:
        the reference only ever printed these values (NeutFEM.cpp:1791-1796)."""
        return getattr(self, "_last_history", np.zeros((0, 4)))

    # -- checkpoint / resume (new scope; the reference has none — SURVEY §5) --

    @staticmethod
    def _ckpt_path(path: str) -> str:
        # np.savez_compressed appends ".npz" when missing; normalize both ends so
        # save_state("ckpt") / load_state("ckpt") round-trips.
        return path if str(path).endswith(".npz") else str(path) + ".npz"

    def save_state(self, path: str):
        """Persist the solver state (flux, adjoint, currents, eigenvalues) to .npz."""
        path = self._ckpt_path(path)
        data = {"keff": np.array(self._keff if self._keff is not None else np.nan),
                "keff_adj": np.array(self._keff_adj if self._keff_adj is not None else np.nan)}
        # flux is stored in USER orientation (portable across internal axis
        # orders); currents keep the internal orientation they were produced
        # in, tagged with the perm so a mismatched load can drop them.
        if self._phi is not None:
            data["phi"] = self._phi_to_user(self._phi)
        if self._phi_adj is not None:
            data["phi_adj"] = self._phi_to_user(self._phi_adj)
        data["axperm"] = np.array(self._axperm, dtype=np.int64)
        for jname, J in (("J", self._J), ("J_adj", self._J_adj)):
            if J is None:
                continue
            for dkey, entry in J.items():
                for part, arr in entry.items():
                    data[f"{jname}_{dkey}_{part}"] = np.asarray(arr)
        np.savez_compressed(path, **data)

    def load_state(self, path: str):
        """Restore a state saved with save_state (warm-starts subsequent solves)."""
        with np.load(self._ckpt_path(path)) as z:
            expected = (self._ng, *self._mesh.shape, self._fes.P)
            if "phi" in z and tuple(z["phi"].shape) != expected:
                raise ValueError(
                    f"checkpoint flux shape {z['phi'].shape} does not match this "
                    f"solver's {expected} (mesh/groups/order differ)"
                )
            if "phi" in z:
                self._phi = jnp.asarray(self._phi_from_user(z["phi"]),
                                        dtype=self._dtype)
            if "phi_adj" in z:
                self._phi_adj = jnp.asarray(self._phi_from_user(z["phi_adj"]),
                                            dtype=self._dtype)
            k = float(z["keff"])
            self._keff = None if np.isnan(k) else k
            ka = float(z["keff_adj"])
            self._keff_adj = None if np.isnan(ka) else ka
            # currents were saved in the writer's internal orientation; drop
            # them if it differs from ours (they are an export convenience and
            # are regenerated by the next solve)
            saved_perm = tuple(int(v) for v in z["axperm"]) if "axperm" in z \
                else (0, 1, 2)
            if saved_perm != self._axperm:
                warnings.warn(
                    f"checkpoint currents were saved with internal axis order "
                    f"{saved_perm} but this solver uses {self._axperm}; "
                    "dropping J/J_adj (flux and eigenvalues are restored)",
                    RuntimeWarning)
                self._J = None
                self._J_adj = None
                return
            J: Dict = {}
            J_adj: Dict = {}
            for key in z.files:
                if key.startswith("J_adj_"):
                    rest = key[len("J_adj_"):]
                    dkey, part = rest.rsplit("_", 1)
                    J_adj.setdefault(dkey, {})[part] = jnp.asarray(z[key], dtype=self._dtype)
                elif key.startswith("J_"):
                    rest = key[len("J_"):]
                    dkey, part = rest.rsplit("_", 1)
                    J.setdefault(dkey, {})[part] = jnp.asarray(z[key], dtype=self._dtype)
            self._J = J or None
            self._J_adj = J_adj or None

    # -- assembly ------------------------------------------------------------

    def BuildMatrices(self):
        """Stage geometry + XS to the device operator context (reference
        BuildMatrices, NeutFEM.cpp:402-457 — here: precomputed stencil tensors +
        tridiagonal factorizations, built once, removing the per-solve
        re-factorization defect NeutFEM.cpp:2094-2097)."""
        t0 = time.time()
        self._ctx_cache.clear()
        self._built = True
        self._ctx("exact")
        self._log(VerbosityLevel.NORMAL,
                  f"BuildMatrices: operator context staged in {time.time() - t0:.3f}s")

    def build_diagonal_cache(self):
        if self._rt_order == 0 and self._p_order == 0:
            self._ctx("diag")

    def initialize_cmfd(self):
        # CMFD coupling data (Dtilde, face areas, current scales) is part of every
        # context build; nothing extra to do.
        self._ctx("exact")

    # -- solves ---------------------------------------------------------------

    def SolveKeff(self, use_coarse_init: bool = False, coarse_factors: Sequence[int] = (),
                  use_diagonal_solver: bool = False, use_cmfd: bool = False,
                  diag_elementwise: bool = False) -> float:
        """use_diagonal_solver=True runs the CONSISTENT diagonal-A Schur: A^-1 is
        approximated by diag(A)^-1 inside the CG matvec, keeping the
        B diag(A)^-1 B^T inter-element coupling.  The reference's own RT0-P0
        "diagonal Schur" (NeutFEM.cpp:459-634) additionally drops that coupling —
        S_ee = C_ee + sum_f B_ef^2/A_ff solved elementwise — which is mathematically
        inconsistent: its eigenvalue collapses under mesh refinement (k ~ 0.60 /
        0.22 / 0.04 on IAEA-2D at 1x/2x/4x).  That scheme is available only as
        loud bug-compat via diag_elementwise=True."""
        a_mode = "diag" if (use_diagonal_solver and self._rt_order == 0
                            and self._p_order == 0) else "exact"
        if diag_elementwise:
            import warnings

            if a_mode != "diag":
                raise ValueError("diag_elementwise requires use_diagonal_solver=True "
                                 "and RT0-P0")
            warnings.warn(
                "diag_elementwise replicates the reference's RT0-P0 diagonal-Schur "
                "scheme (NeutFEM.cpp:459-634), which drops all inter-element "
                "coupling: the eigenvalue it returns collapses toward 0 under mesh "
                "refinement and is NOT a solution of the diffusion problem",
                RuntimeWarning, stacklevel=2,
            )
        self._resolved_solver_kind = None  # re-resolve the direct-solver gate per solve
        ctx = self._ctx(a_mode)
        opts = self._opts(a_mode, use_cmfd=use_cmfd, diag_elementwise=diag_elementwise)

        keff0 = self._keff if self._keff else 1.0
        phi0 = self._phi if self._phi is not None else self._flat_phi()
        if use_coarse_init and len(coarse_factors) > 0:
            k_c, phi0 = coarse_init(
                self._fes, self._ng, self._ixs(), self._ibcs(),
                self._ifactors(coarse_factors),
                self._opts("exact"), self._dtype, marshak_d_factor=True,
            )
            keff0 = float(k_c)
            self._log(VerbosityLevel.NORMAL, f"  coarse init: k-eff = {keff0:.6f}")

        t0 = time.time()
        with self._maybe_profile("SolveKeff"):
            res = self._solver_fn(opts, False, False)(ctx, phi0, keff0)
            host = self._fetch_scalars(res)
        keff = float(host["keff"])
        self._phi = res["phi"]
        self._J = res["J"]
        self._keff = keff
        self._last_outers = int(host["outer_iterations"])
        self._last_inners = int(host["inner_iterations"])
        self._last_schur_iterations = int(host["last_inner_iterations"])
        self._last_schur_residual = float(host["last_inner_residual"])
        self._store_history(host, opts)
        self._check_health(keff, bool(host["finite"]), "SolveKeff")
        self._log(
            VerbosityLevel.NORMAL,
            f"SolveKeff: k-eff = {keff:.6f} in {self._last_outers} outer / "
            f"{self._last_inners} inner iterations "
            f"({time.time() - t0:.3f}s, dk={float(host['diff_k']):.2e}, "
            f"dphi={float(host['diff_flux']):.2e})",
        )
        return keff

    def SolveAdjoint(self, normalize_to_direct: bool = True,
                     use_direct_keff: bool = True) -> float:
        self._resolved_solver_kind = None  # re-resolve the direct-solver gate per solve
        ctx = self._ctx("exact")
        opts = self._opts("exact")
        fixed = self._keff if (use_direct_keff and self._keff) else None
        keff0 = fixed if fixed is not None else (self._keff or 1.0)
        phi0 = self._phi_adj if self._phi_adj is not None else self._flat_phi()

        t0 = time.time()
        res = self._solver_fn(opts, True, fixed is not None)(ctx, phi0, keff0)
        host = self._fetch_scalars(res)
        keff_adj = float(host["keff"]) if fixed is None else float(fixed)
        phi_adj = res["phi"]

        if normalize_to_direct and self._phi is not None:
            ip = biorthogonal_inner(ctx, self._phi, phi_adj)
            ipf = float(ip)
            if abs(ipf) > 1e-14:
                phi_adj = phi_adj / ip  # <phi, phi_adj>_M = 1 (NeutFEM.cpp:2020-2066)

        self._phi_adj = phi_adj
        self._J_adj = res["J"]
        self._keff_adj = keff_adj
        self._last_schur_iterations = int(host["last_inner_iterations"])
        self._last_schur_residual = float(host["last_inner_residual"])
        self._store_history(host, opts)
        self._check_health(keff_adj, bool(host["finite"]), "SolveAdjoint")
        self._log(
            VerbosityLevel.NORMAL,
            f"SolveAdjoint: k-eff(adj) = {keff_adj:.6f} in "
            f"{int(host['outer_iterations'])} outers ({time.time() - t0:.3f}s)",
        )
        return keff_adj

    def SolveSubcritical(self) -> float:
        """Fixed-source subcritical solve (wrapper.cpp:700-715 — unimplemented in the
        reference).  Returns the amplification factor M."""
        self._resolved_solver_kind = None  # re-resolve the direct-solver gate per solve
        ctx = self._ctx("exact")
        opts = self._opts("exact")
        phi0 = jnp.zeros((self._ng, *self._imesh.shape, self._fes.P), dtype=self._dtype)
        res = solve_subcritical(self._fes, self._ng, opts, ctx, phi0,
                                keff=self._keff or 1.0)
        host = jax.device_get({"amplification": res["amplification"],
                               "finite": res["finite"]})
        self._phi = res["phi"]
        self._J = res["J"]
        amp = float(host["amplification"])
        import warnings

        if not (np.isfinite(amp) and bool(host["finite"])) or amp > 1e6:
            warnings.warn(
                f"SolveSubcritical diverged (amplification M = {amp:.3e}): the system "
                "is supercritical (k >= 1) — the fixed-source problem has no bounded "
                "solution", RuntimeWarning, stacklevel=2,
            )
        self._log(VerbosityLevel.NORMAL, f"SolveSubcritical: amplification M = {amp:.4f}")
        return amp

    def SolveCoarse(self, refine: Sequence[int]):
        """Coarse solve + P0 injection (NeutFEM.cpp:2380-2611). Returns (k, flux)."""
        k_c, phi0 = coarse_init(
            self._fes, self._ng, self._ixs(), self._ibcs(), self._ifactors(refine),
            self._opts("exact"), self._dtype, marshak_d_factor=True,
        )
        self._phi = phi0
        self._keff = float(k_c)
        return float(k_c), self._to_user(np.asarray(phi0[..., 0]))

    # -- projection / zoom (wrapper.cpp:1003-1064, unimplemented upstream) ----

    def _refine_factors(self, refine: Sequence[int]):
        r = list(refine) + [1] * (3 - len(refine))
        rx = max(int(r[0]), 1)
        ry = max(int(r[1]), 1) if self._mesh.dim >= 2 else 1
        rz = max(int(r[2]), 1) if self._mesh.dim == 3 else 1
        return rx, ry, rz

    def project_flux(self, refine: Sequence[int], adjoint: bool = False) -> np.ndarray:
        """Exact subcell averages of the polynomial flux on a refined mesh."""
        phi = self._phi_adj if adjoint else self._phi
        if phi is None:
            raise RuntimeError("no flux available: solve first")
        rx, ry, rz = self._refine_factors(refine)
        fes = self._fes
        # user orientation (+ mode reorder); the mode LIST is perm-invariant,
        # so fes.modes below indexes correctly either way
        phi = self._phi_to_user(phi)  # (ng, nz, ny, nx, P)
        Ts = {0: _subcell_average_matrix(fes.m, rx),
              1: _subcell_average_matrix(fes.m, ry),
              2: _subcell_average_matrix(fes.m, rz)}
        ng, nz, ny, nx, P = phi.shape
        out = np.zeros((ng, nz * rz, ny * ry, nx * rx))
        for p in range(P):
            px, py, pz = fes.modes[p]
            term = phi[..., p]
            # tensor outer product of the per-axis subcell averages
            wz = Ts[2][:, pz] if self._mesh.dim == 3 else np.ones(rz)
            wy = Ts[1][:, py] if self._mesh.dim >= 2 else np.ones(ry)
            wx = Ts[0][:, px]
            blk = (term[:, :, None, :, None, :, None]
                   * wz[None, None, :, None, None, None, None]
                   * wy[None, None, None, None, :, None, None]
                   * wx[None, None, None, None, None, None, :])
            out += blk.reshape(ng, nz * rz, ny * ry, nx * rx)
        return self._squeeze(out)

    def project_power(self, refine: Sequence[int], adjoint: bool = False) -> np.ndarray:
        """kappa-Sigma_f * flux on the refined mesh (wrapper.cpp:1024-1043)."""
        rx, ry, rz = self._refine_factors(refine)
        flux = self.project_flux(refine, adjoint)  # squeezed refined flux
        ksf = self._xs["KSF"]
        ksf_f = np.repeat(np.repeat(np.repeat(ksf, rz, axis=1), ry, axis=2), rx, axis=3)
        power = (self._squeeze(ksf_f) * flux).sum(axis=0)
        return power

    def zoom_resolved(self, refine: Sequence[int], adjoint: bool = False) -> np.ndarray:
        """Re-solve on a refined mesh with the fission source frozen from the current
        coarse solution (wrapper.cpp:1047-1064)."""
        phi = self._phi_adj if adjoint else self._phi
        if phi is None or self._keff is None:
            raise RuntimeError("no solution available: solve first")
        rx, ry, rz = self._refine_factors(refine)

        def refine_breaks(b, r):
            if r == 1 or b.size < 2:
                return b
            segs = [np.linspace(b[i], b[i + 1], r + 1)[:-1] for i in range(b.size - 1)]
            return np.append(np.concatenate(segs), b[-1])

        fmesh = CartesianMesh.from_breaks(
            refine_breaks(self._mesh.x_breaks, rx),
            refine_breaks(self._mesh.y_breaks, ry) if self._mesh.dim >= 2 else self._mesh.y_breaks[:1],
            refine_breaks(self._mesh.z_breaks, rz) if self._mesh.dim == 3 else self._mesh.z_breaks[:1],
        )
        ffes = make_fespace(fmesh, self._rt_order, self._p_order)

        def rep(a):
            return np.repeat(np.repeat(np.repeat(a, rz, axis=-3), ry, axis=-2), rx, axis=-1)

        fxs = {k: rep(v) for k, v in self._xs.items()}
        # frozen fission source projected onto the refined cells
        flux_ref = self.project_flux((rx, ry, rz), adjoint)  # squeezed
        full = np.zeros((self._ng, *fmesh.shape))
        self._squeeze(full)[...] = flux_ref
        fiss = (rep(self._xs["NSF"]) * full).sum(axis=0)
        fxs["SRC"] = rep(self._xs["Chi"]) * fiss[None] / self._keff
        fxs["NSF"] = np.zeros_like(fxs["NSF"])  # fission frozen into SRC

        fctx = build_context(ffes, self._ng, fxs, self._bcs, a_mode="exact",
                             dtype=self._dtype, marshak_d_factor=True)
        opts = self._opts("exact")
        phi0 = jnp.zeros((self._ng, *fmesh.shape, ffes.P), dtype=self._dtype)
        res = fixed_source_solve(ffes, self._ng, opts, fctx, phi0, with_fission=False)
        out = np.zeros((self._ng, *fmesh.shape))
        out[...] = np.asarray(res["phi"][..., 0])
        return self._squeeze(out)

    # -- export ----------------------------------------------------------------

    def _cell_current(self, J) -> Optional[np.ndarray]:
        """(ng, nz, ny, nx, 3) cell-average current vectors: mean of the two opposing
        face values per direction (reference VTK export convention)."""
        if J is None:
            return None
        out = np.zeros((self._ng, *self._imesh.shape, 3))
        for di in self._fes.dirs:
            F = np.asarray(J[f"d{di.d}"]["face"])[..., 0]  # t=0 transverse mode
            ax = di.axis + 1
            sl_lo = [slice(None)] * 4
            sl_hi = [slice(None)] * 4
            n = F.shape[ax]
            sl_lo[ax] = slice(0, n - 1)
            sl_hi[ax] = slice(1, n)
            ctx = self._ctx("exact")
            scale = np.asarray(ctx[f"jscale_{f'd{di.d}'}"])
            Fp = F * scale
            out[..., di.d] = 0.5 * (Fp[tuple(sl_lo)] + Fp[tuple(sl_hi)])
        if self._axperm != (0, 1, 2):
            # spatial axes back to user orientation, and vector component c
            # (current along internal cartesian axis c) back to user axis
            # self._axperm[c]
            out = self._to_user(out, tail=1)[..., np.argsort(self._axperm)]
        return out

    def ExportVTK(self, filename: str, export_flux: bool = True,
                  export_current: bool = True, export_xs: bool = False,
                  export_adjoint: bool = False) -> None:
        flux = self.get_flux_full() if (export_flux and self._phi is not None) else None
        adj = self.get_flux_adj_full() if (export_adjoint and self._phi_adj is not None) else None
        cur = self._cell_current(self._J) if export_current and self._J else None
        write_vtk(filename, self._mesh, self._keff or 0.0, flux=flux, flux_adj=adj,
                  current=cur, xs=self._xs if export_xs else None)

    def ExportFluxVTK(self, filename: str) -> None:
        write_vtk(filename, self._mesh, self._keff or 0.0, flux=self.get_flux_full())

    def ExportXSVTK(self, filename: str) -> None:
        write_vtk(filename, self._mesh, self._keff or 0.0, xs=self._xs)

    # -- data access ------------------------------------------------------------

    def get_D(self):
        return self._squeeze(self._xs["D"])

    def get_SRC(self):
        return self._squeeze(self._xs["SRC"])

    def get_SigR(self):
        return self._squeeze(self._xs["SigR"])

    def get_NSF(self):
        return self._squeeze(self._xs["NSF"])

    def get_KSF(self):
        return self._squeeze(self._xs["KSF"])

    def get_Chi(self):
        return self._squeeze(self._xs["Chi"])

    def get_SigS(self):
        return self._squeeze(self._xs["SigS"])

    def get_flux_full(self) -> Optional[np.ndarray]:
        if self._phi is None:
            return None
        # P0 (cell-average) component; mode 0 is (0,0,0) under every axis perm
        return self._to_user(np.asarray(self._phi[..., 0]))

    def get_flux_adj_full(self) -> Optional[np.ndarray]:
        if self._phi_adj is None:
            return None
        return self._to_user(np.asarray(self._phi_adj[..., 0]))

    def get_flux(self):
        full = self.get_flux_full()
        if full is None:
            full = np.zeros((self._ng, *self._mesh.shape))
        return self._squeeze(full)

    def get_flux_adj(self):
        full = self.get_flux_adj_full()
        if full is None:
            full = np.zeros((self._ng, *self._mesh.shape))
        return self._squeeze(full)

    # -- utilities ----------------------------------------------------------------

    def reset_flux(self):
        self._phi = None
        self._phi_adj = None
        self._J = None
        self._J_adj = None
        self._keff = None
        self._keff_adj = None

    def GetNumElements(self) -> int:
        return self._mesh.n_elements

    def GetNumGroups(self) -> int:
        return self._ng

    def GetDimension(self) -> int:
        return self._mesh.dim

    def GetLastKeff(self) -> float:
        return self._keff if self._keff is not None else 0.0

    def GetLastKeffAdjoint(self) -> float:
        return self._keff_adj if self._keff_adj is not None else 0.0

    def GetSolverName(self) -> str:
        return _SOLVER_NAMES[self._solver_type]

    # Solver diagnostics (reference SchurSolver::GetLastIterations/GetLastResidual,
    # solvers.hpp:358-366): Krylov stats of the LAST group solve of the last solve.
    def GetLastIterations(self) -> int:
        return getattr(self, "_last_schur_iterations", 0)

    def GetLastResidual(self) -> float:
        return getattr(self, "_last_schur_residual", 0.0)

    def GetLastOuterIterations(self) -> int:
        """Total outer (power) iterations of the last SolveKeff."""
        return getattr(self, "_last_outers", 0)

    def GetLastInnerIterations(self) -> int:
        """Total Schur-CG iterations summed over the last SolveKeff."""
        return getattr(self, "_last_inners", 0)
