"""Multigroup k-effective power iteration, entirely on-device.

Rebuild of ``NeutFEM::SolveKeff`` (reference ``src/NeutFEM.cpp:1627-1826``):
the whole outer loop — fission source, Gauss-Seidel-in-source group sweep with
matrix-free Schur CG group solves, eigenvalue update, normalization, Chebyshev/Anderson
acceleration, convergence control — runs inside one ``lax.while_loop`` under ``jit``
with zero host round-trips.  Matching reference semantics:

* fission source ``total_fiss = sum_g M_fiss[g] phi_g`` (NeutFEM.cpp:1700-1707)
* group rhs ``chi_g * total_fiss / k + sum_{g'!=g} M_scatter[g<-g'] phi_g'``
  with fresh (already swept) fluxes — Gauss-Seidel in the scattering source
* k-update ``k <- k * prod_new / prod_old`` skipped at iteration 0 (NeutFEM.cpp:1766-1774)
* L2 flux-diff convergence + normalization (NeutFEM.cpp:1777-1783)
* Chebyshev acceleration from iteration >= 2 with (nmax=15, sigma=0.98)
* stop when ``dk < tol_keff`` and ``dphi < tol_flux``

Differences (documented): group solves warm-start from the current flux (the reference
restarts CG from zero every solve, solvers.cpp:585) and use Jacobi (diag-S) PCG instead
of unpreconditioned CG — identical fixed point, fewer iterations.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .accel import (
    anderson_apply,
    anderson_init,
    chebyshev_apply,
    chebyshev_apply_blend,
    chebyshev_init,
)
from .cmfd import cmfd_correction
from .fespace import FESpace
from .krylov import bicgstab, pcg, pcg_fused
from .ops.apply import (
    J_to_public,
    apply_B_dir,
    apply_BT_dir,
    cyc_args,
    phi_to_internal,
    phi_to_public,
    schur_matvec,
    solve_A_dir,
)

__all__ = [
    "SolveOptions",
    "power_iteration",
    "fixed_source_solve",
    "solve_subcritical",
    "biorthogonal_inner",
    "compute_current",
    "group_solve",
    "block_jacobi_apply",
]


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Static solver configuration (hashable; goes into the jit closure)."""

    tol_keff: float = 1e-5
    tol_flux: float = 1e-5
    inner_tol: float = 1e-5       # Schur CG relative tolerance (= tol_flux in reference)
    inner_eta: float = 0.0        # > 0: adaptive (Eisenstat-Walker-style) inner
                                  # tolerance — each outer's group solves run at
                                  # clip(inner_eta * dphi_prev, inner_tol, 0.1),
                                  # so early outers (flux error ~1e0) stop the
                                  # Schur CG early and only the endgame pays for
                                  # full inner accuracy.  0 = reference-parity
                                  # fixed tolerance.  NEUTFEM_INNER_ETA wires it
                                  # through the compat layer.
    max_outer: int = 200
    max_inner: int = 1000
    accel: str = "chebyshev"      # "none" | "chebyshev" | "anderson"
    cheby_nmax: int = 15
    cheby_sigma: float = 0.98
    anderson_m: int = 4
    a_mode: str = "exact"         # A-inverse mode: "exact" | "diag" | "lumped"
    warm_start: bool = True
    inner_solver: str = "cg"      # "cg" | "bicgstab"
    inner_precond: str = "auto"   # Schur CG preconditioner: "line" (tridiagonal
                                  # part of the diagonal-A Schur along the highest
                                  # active direction, one batched Thomas apply per
                                  # iteration; P=1 single-device only — falls back
                                  # silently) | "line2" (adds the second direction
                                  # additively: fewer iterations, but the extra
                                  # apply does not always pay; opt-in) | "jacobi"
                                  # (diag-S equilibration only) | "twogrid"
                                  # (additive coarse-grid correction on top of
                                  # the fine preconditioner — requires
                                  # twogrid.attach_twogrid on the ctx; declines
                                  # to the fine preconditioner under sharding
                                  # or when unattached) | "auto" (line
                                  # from 3M cells, jacobi below — see
                                  # group_solve)
    tg_degree: int = 8            # twogrid: Chebyshev degree of the coarse
                                  # approximate inverse (= coarse matvecs per
                                  # CG iteration)
    tg_kappa: float = 30.0        # twogrid: Chebyshev interval [lmax/kappa, lmax]
    use_cmfd: bool = False        # CMFD nonlinear acceleration (excludes Chebyshev)
    cmfd_omega: float = 1.0       # CMFD correction relaxation (SetCMFDRelaxation)
    cmfd_from_iter: int = 2       # first outer iteration with CMFD (NeutFEM.cpp:1750)
    cmfd_mode: str = "fixed"      # "fixed": reference-style single lo solve
                                  # (stable; converges to the right k but gains
                                  # little — the exact-closure lo operator is
                                  # INDEFINITE for this discretization, see
                                  # cmfd.cmfd_correction docstring) |
                                  # "wielandt": experimental lo eigensolve
    cmfd_use_lo_k: bool = False   # take keff from the lo eigensolve (wielandt
                                  # mode only; unstable on indefinite lo systems)
    cmfd_lo_outers: int = 60      # wielandt-mode cap on lo iterations
    cheby_blend: bool = True      # branch-free Chebyshev (scalar-masked blend,
                                  # accel.chebyshev_apply_blend) instead of
                                  # lax.cond+switch: the control-flow form
                                  # materializes every flux-sized branch
                                  # operand.  NEUTFEM_CHEBBLEND=0 reverts via
                                  # the compat layer for A/B.
    sweep: str = "gs"             # group sweep: "gs" (reference Gauss-Seidel) |
                                  # "jacobi" (all groups in ONE batched Schur CG).
                                  # Jacobi is cheaper per outer on 4-group
                                  # problems but needs more outers and excludes
                                  # Chebyshev; kept opt-in.
    diag_elementwise: bool = False  # bug-compat RT0-P0 elementwise Schur solve:
                                  # replicates the reference's S_ee = C_ee +
                                  # sum_f B_ef^2/A_ff scheme (NeutFEM.cpp:459-634),
                                  # which drops ALL inter-element coupling and
                                  # collapses under mesh refinement.  OFF by default;
                                  # a_mode="diag" alone keeps the CONSISTENT
                                  # diagonal-A Schur (A^-1 ~ diag(A)^-1 but the
                                  # B diag(A)^-1 B^T neighbor coupling retained).
    log_every: int = 0            # if > 0, jax.debug.print "It n : k dk dphi" every
                                  # log_every outer iterations (reference
                                  # NeutFEM.cpp:1791-1796 prints every 5).


def ctx_group(ctx: Dict, g: int) -> Dict:
    """Slice the per-group arrays of the operator context for group g (static int)."""
    out = {}
    for k, v in ctx.items():
        if isinstance(v, dict):
            # nested sub-context (e.g. the two-grid coarse context under "tg"):
            # same per-group key-prefix rules, recursively
            out[k] = ctx_group(v, g)
        elif k.startswith(("C", "alpha_", "tri_", "precond", "cyc_", "src_bc",
                           "jcorr_", "schur_")):
            out[k] = v[g]
        else:
            out[k] = v
    return out


def block_jacobi_apply(ctxg: Dict):
    """The P x P per-cell block-Jacobi preconditioner r -> Binv r (higher
    orders), or None when the context stores none.  It captures the inter-mode
    coupling of the Schur diagonal block that pointwise Jacobi ignores (built
    on the equilibrated system in build_context) and is spatially elementwise,
    so it needs no sharding special-case.  Storage tiers
    (ops/context.store_block_inverse): fp8 E-form z = r + E r with
    E = Binv - I upcast inside the einsum fusion (the identity part exact), or
    the inverse itself."""
    if "precond_blk_dev" in ctxg:
        dev = ctxg["precond_blk_dev"]
        return lambda r: r + jnp.einsum(
            "...pqabc,...qabc->...pabc", dev.astype(jnp.bfloat16), r)
    if "precond_blk_inv" in ctxg:
        bi = ctxg["precond_blk_inv"]
        return lambda r: jnp.einsum("...pqabc,...qabc->...pabc", bi, r)
    return None


def group_solve(fes: FESpace, ctxg: Dict, opts: SolveOptions, rhs, x0, tol=None):
    """Solve S_g phi_g = rhs via symmetrically Jacobi-equilibrated CG (or BiCGSTAB).

    ``tol`` (traced scalar) overrides ``opts.inner_tol`` — used by the adaptive
    inner-tolerance schedule (``opts.inner_eta``).

    The solve runs on the scaled system  D^-1/2 S D^-1/2 y = D^-1/2 rhs  with
    D = diag(S) (the diagonal-Schur estimate).  This is mathematically identical to
    Jacobi-PCG on S, but every Krylov intermediate is O(1): required in float32,
    where the raw dot products overflow for problems with near-void cells
    (Sigma_r ~ 1e8-1e15 in the IAEA-3D / KOEBERG benchmark fillers).

    With diag_elementwise (bug-compat only), the RT0-P0 "diag" solve is a single
    elementwise product with the reference's per-element S_ee — the reference's
    diagonal-Schur fast path (NeutFEM.cpp:607-634).  That scheme has NO neighbor
    coupling (it drops the off-diagonal B_ef B_e'f / A_ff terms of shared faces) and
    its eigenvalue collapses under mesh refinement; the default "diag" path keeps
    the consistent diagonal-A Schur: A^-1 ~ diag(A)^-1 inside the CG matvec, which
    retains the inter-element coupling."""
    if opts.diag_elementwise and opts.a_mode == "diag" and fes.k == 0 and fes.m == 0:
        from .krylov import KrylovResult

        x = ctxg["precond_inv"] * rhs
        return KrylovResult(
            x=x,
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(0.0, rhs.dtype),
        )
    if opts.inner_solver == "direct":
        # explicit-Schur direct path (reference solvers.cpp:259-427): the dense
        # equilibrated Cholesky factors were attached to ctx at build time
        # (ops/direct.attach_dense_schur); each solve is two triangular solves.
        from .krylov import KrylovResult
        from .ops.direct import direct_solve

        x = direct_solve(ctxg, rhs)
        return KrylovResult(
            x=x,
            iterations=jnp.asarray(1, jnp.int32),
            residual=jnp.asarray(0.0, rhs.dtype),
        )
    sdi = jnp.sqrt(ctxg["precond_inv"])  # D^-1/2
    matvec = lambda y: sdi * schur_matvec(fes, ctxg, y * sdi, a_mode=opts.a_mode)
    if opts.inner_solver == "cg":
        # Textbook PCG by default.  The Chronopoulos-Gear fused-reduction variant
        # (NEUTFEM_CGCG=1) saves two reduction kernels per iteration but adds two
        # axpys and two carried vectors of device-memory traffic; opt-in.
        solver = pcg_fused if os.environ.get("NEUTFEM_CGCG", "0") == "1" else pcg
    else:
        solver = bicgstab
    precond = None
    pc_mode = opts.inner_precond
    if pc_mode == "auto":
        if fes.P == 1 and "tg" in ctxg:
            # An attached coarse context under "auto" means the 2D-fine-mesh
            # rule fired (twogrid.auto_twogrid via the compat layer; 3D and
            # coarse 2D never auto-attach).  Under sharding the branch below
            # declines to the fine part.
            pc_mode = "twogrid"
        elif fes.P > 1:
            pc_mode = "block"
        else:
            # CG conditioning grows ~h^-1, so the line preconditioner (one
            # extra Thomas apply per inner) pays off only once meshes get fine
            # enough: the rule is a cell count, 3M.  The threshold has not
            # been measured on the GPU yet (ROADMAP.md lists it).
            pc_mode = "line" if fes.mesh.n_elements >= 3_000_000 else "jacobi"
    tg_corr = None
    if pc_mode == "twogrid":
        # Additive two-grid (twogrid.py): coarse correction ON TOP of the usual
        # fine-level preconditioner.  Declines (fine part only — same fixed
        # point) when the coarse context is unattached or under spatial
        # sharding (the coarse matvec is not shard-mapped).
        from .shardctx import current_sharding as _tg_sharding

        if "tg" in ctxg and _tg_sharding() is None:
            from .twogrid import twogrid_correction

            tg_corr = lambda r: twogrid_correction(fes, ctxg, opts, r)
        pc_mode = "block" if fes.P > 1 else "jacobi"
    if pc_mode == "block":
        precond = block_jacobi_apply(ctxg)
    if pc_mode in ("line", "line2") and "precond_line_dinv" in ctxg:
        from .fespace import GRID_AXIS
        from .ops.tridiag import tridiag_solve
        from .shardctx import current_sharding

        # Line-tridiagonal part of the equilibrated Schur along the highest
        # active direction (unit diagonal; factors built once in build_context).
        # One batched Thomas solve per CG iteration — cuts the ~h^-1 iteration
        # growth on fine meshes.  "line2" adds the second direction ADDITIVELY
        # (M^-1 = M1^-1 + M2^-1, SPD as a sum of SPD solves).  Under spatial
        # sharding the solve runs per shard via the tridiag shard_map plumbing
        # when the line direction is orthogonal to every cut; a line ALONG a cut
        # falls back to Jacobi (same fixed point, only the iteration count
        # changes).
        sh = current_sharding()

        def _line_apply(key_d, key_l, ga):
            ax = ga - 3
            pld = jnp.expand_dims(ctxg[key_d], -4)
            pll = jnp.expand_dims(ctxg[key_l], -4)

            def apply(r):
                shard = None
                if sh is not None:
                    mesh_, amap = sh
                    shard = (mesh_, {r.ndim - 3 + g: nm for g, nm in amap.items()})
                return tridiag_solve(r, pld, pll, axis=ax % r.ndim, shard=shard)

            return apply

        pc_dirs = sorted((di.d for di in fes.dirs), reverse=True)

        def _usable(d):
            return sh is None or GRID_AXIS[d] not in sh[1]

        applies = []
        if _usable(pc_dirs[0]):
            applies.append(_line_apply("precond_line_dinv", "precond_line_l",
                                       GRID_AXIS[pc_dirs[0]]))
        if (pc_mode == "line2" and len(pc_dirs) > 1
                and "precond_line2_dinv" in ctxg and _usable(pc_dirs[1])):
            applies.append(_line_apply("precond_line2_dinv", "precond_line2_l",
                                       GRID_AXIS[pc_dirs[1]]))
        if len(applies) == 1:
            precond = applies[0]
        elif applies:
            precond = lambda r: applies[0](r) + applies[1](r)
    if tg_corr is not None:
        base = precond if precond is not None else (lambda r: r)
        precond = lambda r, _b=base: _b(r) + tg_corr(r)
    res = solver(matvec, rhs * sdi, x0 / sdi, precond=precond,
                 tol=opts.inner_tol if tol is None else tol,
                 maxiter=opts.max_inner)
    return res._replace(x=res.x * sdi)


def _fission_source(ctx, phi, adjoint: bool = False):
    """Direct: total_fiss = sum_g (nuSigf_g-weighted mass) phi_g   (NeutFEM.cpp:1700-1707).
    Adjoint: total_chi = sum_g (chi_g-weighted mass) phi_adj_g     (NeutFEM.cpp:1919-1924).
    phi internal (ng, P, sp); returns (P, sp)."""
    w = (ctx["chi"] if adjoint else ctx["nsf"]) * ctx["detJ"]  # (ng, nz, ny, nx)
    return jnp.sum(jnp.expand_dims(w, -4) * (ctx["w_mode_col"] * phi), axis=0)


def _production(ctx, phi, adjoint: bool = False):
    """Reference 'production' functional: total components of F phi (F^T phi_adj)."""
    if adjoint:
        # sum_g sum_dofs nuSigf_g * total_chi  (NeutFEM.cpp:1929-1932, 1963-1966)
        total_chi = _fission_source(ctx, phi, adjoint=True)
        return jnp.sum(jnp.sum(ctx["nsf"], axis=0) * total_chi)
    w = ctx["nsf"] * ctx["detJ"]
    return jnp.sum(jnp.expand_dims(w, -4) * (ctx["w_mode_col"] * phi))


def _scatter_into(ctx, g: int, phi, adjoint: bool = False):
    """Direct: sum_{g' != g} (SigS[g<-g']-weighted mass) phi_g'  (NeutFEM.cpp:1719-1726).
    Adjoint uses the transposed coupling SigS[g'<-g] (NeutFEM.cpp:1944-1950)."""
    ng = phi.shape[0]
    out = 0.0
    for gp in range(ng):
        if gp == g:
            continue
        sig = ctx["sigs"][gp, g] if adjoint else ctx["sigs"][g, gp]
        w = sig * ctx["detJ"]  # (nz, ny, nx): broadcasts against (P, sp)
        out = out + w * (ctx["w_mode_col"] * phi[gp])
    return out


def _scatter_all(ctx, phi, adjoint: bool = False):
    """Stacked off-diagonal scattering source for every group at once."""
    return jnp.stack([_scatter_into(ctx, g, phi, adjoint) for g in range(phi.shape[0])])


def _external_source(ctx, g: int):
    """Flux-space rhs of the per-element-constant external source Q_g: only the P_0
    mode is excited, with weight detJ * w_mode[0] (= volume * 1 in P0 units).
    Adds the fixed boundary source of any inhomogeneous (nonzero-NEUMANN) BC."""
    wm = ctx["w_mode_col"]  # (P, 1, 1, 1)
    onehot = jnp.zeros_like(wm).at[0].set(wm[0])
    out = (ctx["src"][g] * ctx["detJ"]) * onehot  # (P, nz, ny, nx)
    if "src_bc" in ctx:
        out = out + ctx["src_bc"][g]
    return out


def compute_current(fes: FESpace, ctx: Dict, phi, a_mode: str = "exact"):
    """J = A^{-1} B^T phi for all groups: the physical current DOFs (J = -D grad phi).

    phi and the returned J use the INTERNAL mode-first layout (ops/apply.py header);
    convert with J_to_public for the reference-shaped trailing-mode layout."""
    J = {}
    from .ops.apply import ctx_face

    for di in fes.dirs:
        key = f"d{di.d}"
        rF, rW = apply_BT_dir(fes, di, phi)
        F, W = solve_A_dir(
            fes,
            di,
            ctx_face(ctx, f"tri_dinv_{key}", di.axis),
            ctx.get(f"tri_l_{key}"),
            ctx_face(ctx, f"mask_{key}", di.axis),
            ctx[f"alpha_{key}"],
            rF,
            rW,
            a_mode,
            cyc=cyc_args(ctx, key),
        )
        jc = ctx.get(f"jcorr_{key}")
        if jc is not None:
            F = F + jnp.expand_dims(jc, -4)  # inhomogeneous-NEUMANN lift J = J' + J_q
        J[key] = {"face": F} if W is None else {"face": F, "bub": W}
    return J


def power_iteration(
    fes: FESpace,
    ng: int,
    opts: SolveOptions,
    ctx: Dict,
    phi0,
    keff0,
    adjoint: bool = False,
    fixed_keff: Optional[float] = None,
):
    """Run the accelerated power iteration.  Returns a result dict (device arrays).

    phi0: (ng, nz, ny, nx, P) initial flux (public trailing-mode layout; converted
    to the internal mode-first layout at entry — see ops/apply.py header — and back
    at exit, so results keep the reference-shaped layout).
    keff0: scalar initial eigenvalue.
    adjoint: solve the adjoint problem (transposed chi/nuSigf/SigS coupling,
    NeutFEM.cpp:1877-2082); A and C are symmetric so the same Schur solve is reused.
    fixed_keff: if given, the eigenvalue is held fixed (reference use_direct_keff mode)
    and convergence is on the flux only.
    """
    phi0 = phi_to_internal(phi0)
    dtype = phi0.dtype
    # Chebyshev is applied only when CMFD is off (reference NeutFEM.cpp:1786-1788).
    # It is also disabled for the Jacobi group sweep: that iteration's subdominant
    # spectrum is not confined to the real interval Chebyshev assumes and the
    # extrapolation diverges (Anderson remains available there).
    use_cheby = (opts.accel == "chebyshev" and not opts.use_cmfd
                 and opts.sweep != "jacobi")
    use_anderson = opts.accel == "anderson" and not opts.use_cmfd
    cheby_from = 5 if adjoint else 2  # reference NeutFEM.cpp:1786 vs :1990

    cheb0 = chebyshev_init(phi0)
    and0 = anderson_init(phi0.size, opts.anderson_m, dtype)

    rhs_w = ctx["nsf"] if adjoint else ctx["chi"]  # group-row weight of the fission rhs

    # Adaptive-schedule endgame floor: an outer solved at tolerance tol_g cannot
    # certify flux accuracy better than ~tol_g, so convergence only counts once
    # the schedule has tightened to this floor (otherwise a loose early solve
    # that barely moves the warm-started flux fakes a tiny dphi/dk and the
    # iteration stops on the WRONG eigenpair — observed: eta=0.1 "converged" in
    # 3 outers 640 pcm off).  A fake-small dphi tightens the next outer's tol_g,
    # so the guard self-corrects instead of stalling.
    endgame_tol = max(opts.inner_tol, 0.1 * opts.tol_flux) * 1.0001

    def outer_body(carry):
        phi, keff, it, _, dphi_prev, cheb, ands, inner_tot, _, _, hist, _ = carry
        phi_old = phi

        # Adaptive inner tolerance (opt-in): solve each outer's group systems
        # only as accurately as the outer iterate itself — clip(eta * dphi_prev,
        # inner_tol, 0.1).  dphi_prev starts at 1.0, so the first outers run at
        # the 0.1 cap and the schedule tightens to inner_tol as the flux
        # converges (the stopping rule then matches the fixed-tol endgame).
        tol_g = None
        tol_used = jnp.asarray(opts.inner_tol, dtype)
        if opts.inner_eta > 0:
            tol_g = jnp.clip(jnp.asarray(opts.inner_eta, dtype) * dphi_prev,
                             opts.inner_tol, 0.1)
            tol_used = tol_g

        total_fiss = _fission_source(ctx, phi, adjoint)
        prod_old = _production(ctx, phi, adjoint) if adjoint else jnp.sum(total_fiss)

        inner_iters = jnp.asarray(0, jnp.int32)
        last_inner = jnp.asarray(0, jnp.int32)
        last_resid = jnp.asarray(0.0, dtype)
        if opts.sweep == "jacobi":
            # all groups at once: scattering from the OLD fluxes, one batched CG over
            # the leading group axis (ctx arrays already carry ng in front)
            rhs = jnp.expand_dims(rhs_w, -4) * total_fiss / keff + _scatter_all(ctx, phi, adjoint)
            x0 = phi if opts.warm_start else jnp.zeros_like(phi)
            res = group_solve(fes, ctx, opts, rhs, x0, tol=tol_g)
            phi = res.x
            inner_iters = inner_iters + res.iterations
            last_inner = res.iterations
            last_resid = jnp.max(res.residual).astype(dtype)
            sweep_order = ()
        else:
            # Adjoint sweeps groups in REVERSE: importance flows up the group ladder,
            # so decreasing g is the ordering that makes the Gauss-Seidel scattering
            # sweep triangular for the transposed coupling.  (The reference sweeps
            # forward in both modes, NeutFEM.cpp:1936 — with a forward adjoint sweep
            # the Chebyshev extrapolation destabilizes; documented deviation.)
            sweep_order = range(ng - 1, -1, -1) if adjoint else range(ng)
        for g in sweep_order:
            ctxg = ctx_group(ctx, g)
            # chi (nuSigf in adjoint mode) is constant per element, so it multiplies
            # every local mode of the (already mass-weighted) fission source
            # (reference BuildFissionRHS, NeutFEM.cpp:1539-1589).
            rhs = rhs_w[g] * total_fiss / keff  # (sp) * (P, sp)
            rhs = rhs + _scatter_into(ctx, g, phi, adjoint)
            x0 = phi[g] if opts.warm_start else jnp.zeros_like(phi[g])
            res = group_solve(fes, ctxg, opts, rhs, x0, tol=tol_g)
            phi = phi.at[g].set(res.x)
            inner_iters = inner_iters + res.iterations
            last_inner = res.iterations
            last_resid = res.residual.astype(dtype)

        cmfd_active = jnp.asarray(False)
        k_lo = keff
        if opts.use_cmfd and not adjoint:
            # CMFD correction from iter >= cmfd_from_iter, BEFORE the k-update
            # (reference ordering, NeutFEM.cpp:1750-1761).  The lo mini-eigensolve
            # also returns its eigenvalue, which replaces the fission-ratio update.
            def do_cmfd(args):
                p, k = args
                Jc = compute_current(fes, ctx, p, a_mode=opts.a_mode)
                ratio, klo = cmfd_correction(fes, ctx, p, Jc, k,
                                             omega=opts.cmfd_omega,
                                             lo_outers=opts.cmfd_lo_outers,
                                             mode=opts.cmfd_mode)
                return p * jnp.expand_dims(ratio, -4), klo

            cmfd_active = it >= opts.cmfd_from_iter
            phi, k_lo = lax.cond(cmfd_active, do_cmfd, lambda a: a, (phi, keff))

        prod_new = _production(ctx, phi, adjoint)
        safe_old = jnp.where(prod_old == 0, 1.0, prod_old)
        keff_new = keff * prod_new / safe_old
        if opts.use_cmfd and not adjoint and opts.cmfd_use_lo_k:
            keff_new = jnp.where(cmfd_active, k_lo, keff_new)
        diff_k = jnp.abs(keff_new - keff)
        if fixed_keff is None:
            keff = jnp.where(it >= 1, keff_new, keff)
        else:
            diff_k = jnp.zeros_like(diff_k)

        sol_norm_sq = jnp.sum(phi * phi)
        diff_norm_sq = jnp.sum((phi - phi_old) ** 2)
        diff_flux = jnp.sqrt(diff_norm_sq / jnp.where(sol_norm_sq == 0, 1.0, sol_norm_sq))
        norm = jnp.sqrt(sol_norm_sq)
        phi = phi / jnp.where(norm > 1e-14, norm, 1.0)

        if use_cheby:
            # Branch-free by default: the lax.cond+switch pair materializes every
            # flux-sized branch operand; the masked-scalar blend fuses into the
            # normalization chain.
            # cheby_blend=False reverts to the control-flow form for A/B.
            if opts.cheby_blend:
                cheb, phi = chebyshev_apply_blend(
                    cheb, phi, it >= cheby_from, opts.cheby_nmax, opts.cheby_sigma
                )
            else:
                def do_accel(args):
                    cheb_in, p = args
                    return chebyshev_apply(cheb_in, p, opts.cheby_nmax, opts.cheby_sigma)

                cheb, phi = lax.cond(
                    it >= cheby_from, do_accel, lambda args: args, (cheb, phi)
                )
        elif use_anderson:
            def do_and(args):
                a_in, p_prev, p = args
                a_out, p_flat = anderson_apply(a_in, p_prev.reshape(-1), p.reshape(-1))
                return a_out, p_flat.reshape(p.shape)

            ands, phi = lax.cond(
                it >= 2,
                do_and,
                lambda args: (args[0], args[2]),
                (ands, phi_old, phi),
            )

        if opts.log_every > 0:
            # reference per-iteration console line (NeutFEM.cpp:1791-1796), printed
            # from inside the jitted loop via the host callback of jax.debug.print
            def _pr(args):
                it_, k_, dk_, dphi_, ni_ = args
                jax.debug.print(
                    "  It {i} : k = {k:.8f}  dk = {dk:.2e}  dphi = {dphi:.2e}"
                    "  (inner {n})",
                    i=it_, k=k_, dk=dk_, dphi=dphi_, n=ni_, ordered=False,
                )
                return 0

            lax.cond(it % opts.log_every == 0, _pr, lambda a: 0,
                     (it, keff, diff_k, diff_flux, inner_iters))

        # Per-iteration history buffer (k, dk, dphi, inner iters) in a fixed-size
        # carry array: the compat layer's get_iteration_history reads it after
        # the solve (the reference only printed these, NeutFEM.cpp:1791-1796).
        hist = lax.dynamic_update_slice(
            hist,
            jnp.stack([keff, diff_k, diff_flux,
                       inner_iters.astype(dtype)])[None],
            (it, jnp.zeros_like(it)),
        )

        return (phi, keff, it + 1, diff_k, diff_flux, cheb, ands,
                inner_tot + inner_iters, last_inner, last_resid, hist, tol_used)

    def outer_cond(carry):
        _, _, it, diff_k, diff_flux, _, _, _, _, _, _, tol_used = carry
        not_conv = jnp.logical_or(diff_k >= opts.tol_keff, diff_flux >= opts.tol_flux)
        if opts.inner_eta > 0:
            # convergence certified only by an endgame-tolerance outer
            not_conv = jnp.logical_or(not_conv, tol_used > endgame_tol)
        # always run at least 2 iterations (k is not updated at it=0)
        return jnp.logical_and(it < opts.max_outer, jnp.logical_or(not_conv, it < 2))

    one = jnp.asarray(1.0, dtype)
    carry0 = (
        phi0,
        jnp.asarray(keff0, dtype),
        jnp.asarray(0, jnp.int32),
        one,
        one,
        cheb0,
        and0,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0.0, dtype),
        jnp.zeros((opts.max_outer, 4), dtype),
        jnp.asarray(1.0, dtype),  # tol_used by the last outer (adaptive guard)
    )
    (phi, keff, it, diff_k, diff_flux, _, _, inner_tot, last_inner, last_resid,
     hist, _) = lax.while_loop(outer_cond, outer_body, carry0)

    J = compute_current(fes, ctx, phi, a_mode=opts.a_mode)
    return {
        "keff": keff,
        "phi": phi_to_public(phi),
        "J": J_to_public(J),
        "outer_iterations": it,
        "inner_iterations": inner_tot,
        # last group solve's Krylov diagnostics (reference SchurSolver::
        # GetLastIterations/GetLastResidual, solvers.hpp:358-366)
        "last_inner_iterations": last_inner,
        "last_inner_residual": last_resid,
        "diff_k": diff_k,
        "diff_flux": diff_flux,
        # (max_outer, 4) per-outer history [k, dk, dphi, inner iters]; rows past
        # outer_iterations are zero.
        "history": hist,
        # health flag computed ON DEVICE so the compat layer's post-solve check
        # rides the same single device->host transfer as the other scalars.
        "finite": jnp.isfinite(keff) & jnp.all(jnp.isfinite(phi)),
    }


def power_iteration_jit(fes: FESpace, ng: int, opts: SolveOptions):
    """A jitted, reusable power-iteration kernel for (fes, ng, opts)."""
    return jax.jit(partial(power_iteration, fes, ng, opts))


def biorthogonal_inner(ctx, phi, phi_adj):
    """<phi, phi_adj>_M with the Legendre mass weights (NeutFEM.cpp:2020-2066):
    sum_g sum_{e,p} phi phi_adj * detJ_e * w_mode_p."""
    return jnp.sum(phi * phi_adj * ctx["detJ"][..., None] * ctx["w_mode"])


def fixed_source_solve(
    fes: FESpace,
    ng: int,
    opts: SolveOptions,
    ctx: Dict,
    phi0,
    with_fission: bool = True,
    keff: float = 1.0,
):
    """Fixed-source (subcritical) solve: H phi = (1/keff) F phi + Q.

    Reference intent per the ``SolveSubcritical`` docstring (wrapper.cpp:700-715; the
    C++ implementation was never shipped): iterate the fission source at fixed k until
    the flux stagnates; the external source Q (per-element constant, ctx["src"]) drives
    the P_0 mode.  With ``with_fission=False`` this is a pure source problem (still
    iterated, to converge upscatter through the Gauss-Seidel group sweep).
    """
    phi0 = phi_to_internal(phi0)
    # same adaptive-schedule endgame floor as power_iteration (convergence is
    # only certified by an inner_tol-accurate source iteration)
    endgame_tol = max(opts.inner_tol, 0.1 * opts.tol_flux) * 1.0001

    def outer_body(carry):
        phi, it, dphi_prev, inner_tot, _ = carry
        phi_old = phi
        total_fiss = _fission_source(ctx, phi) if with_fission else 0.0

        tol_g = None
        tol_used = jnp.asarray(opts.inner_tol, phi0.dtype)
        if opts.inner_eta > 0:
            tol_g = jnp.clip(jnp.asarray(opts.inner_eta, phi0.dtype) * dphi_prev,
                             opts.inner_tol, 0.1)
            tol_used = tol_g

        inner_iters = jnp.asarray(0, jnp.int32)
        for g in range(ng):
            ctxg = ctx_group(ctx, g)
            rhs = _external_source(ctx, g)
            if with_fission:
                rhs = rhs + ctx["chi"][g] * total_fiss / keff
            rhs = rhs + _scatter_into(ctx, g, phi)
            x0 = phi[g] if opts.warm_start else jnp.zeros_like(phi[g])
            res = group_solve(fes, ctxg, opts, rhs, x0, tol=tol_g)
            phi = phi.at[g].set(res.x)
            inner_iters = inner_iters + res.iterations

        num = jnp.sum((phi - phi_old) ** 2)
        den = jnp.sum(phi * phi)
        diff = jnp.sqrt(num / jnp.where(den == 0, 1.0, den))
        return (phi, it + 1, diff, inner_tot + inner_iters, tol_used)

    def outer_cond(carry):
        _, it, diff, _, tol_used = carry
        not_conv = diff >= opts.tol_flux
        if opts.inner_eta > 0:
            not_conv = jnp.logical_or(not_conv, tol_used > endgame_tol)
        return jnp.logical_and(it < opts.max_outer, not_conv)

    one = jnp.asarray(1.0, phi0.dtype)
    phi, it, diff, inner_tot, _ = lax.while_loop(
        outer_cond, outer_body,
        (phi0, jnp.asarray(0, jnp.int32), one, jnp.asarray(0, jnp.int32), one),
    )
    J = compute_current(fes, ctx, phi, a_mode=opts.a_mode)
    return {
        "phi": phi_to_public(phi),
        "J": J_to_public(J),
        "outer_iterations": it,
        "inner_iterations": inner_tot,
        "diff_flux": diff,
        # on-device health flag — see power_iteration's note
        "finite": jnp.all(jnp.isfinite(phi)),
    }


def solve_subcritical(fes: FESpace, ng: int, opts: SolveOptions, ctx: Dict, phi0, keff: float = 1.0):
    """Subcritical amplification: M = ||phi_with_fission|| / ||phi_without_fission||
    (wrapper.cpp:708: 'Facteur d'amplification M = flux_avec_fission / flux_sans_fission')."""
    res_f = fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=True, keff=keff)
    res_0 = fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=False)
    n_f = jnp.sqrt(jnp.sum(res_f["phi"] ** 2))
    n_0 = jnp.sqrt(jnp.sum(res_0["phi"] ** 2))
    amplification = n_f / jnp.where(n_0 == 0, 1.0, n_0)
    return {**res_f, "amplification": amplification, "phi_no_fission": res_0["phi"]}
