"""Additive two-grid preconditioner for the Schur CG group solves.

Motivation (round-3 VERDICT Next #3): the equilibrated Schur CG's iteration
count grows ~h^-1 under mesh refinement (inners/outer 31 -> 43 -> 39(line)
across 988k/2.6M/3.5M IAEA-3D cells); Jacobi equilibration and the line
preconditioner only damp the growth.  A coarse-grid correction targets the
smooth error components CG resolves slowly.  The reference's answers to the
same problem are CMFD and coarse-grid *initialization*
(/root/reference/src/NeutFEM.cpp:662-1017, 2380-2611) — both outer-level
devices; this is an inner-level preconditioner, built from the
machinery that already exists (``coarse.coarsen_xs`` + the RT0-P0 Schur
matvec, with the kernels where the coarse shapes pass their shape rules).

Design — chosen so plain CG remains valid (the preconditioner must be a FIXED
SPD linear operator):

    M^-1 = B_fine  +  E_f P E_c p_k(S_c_eq) E_c P^T E_f

* ``B_fine``: the existing fine-level preconditioner (identity on the
  equilibrated RT0 system; the P x P block-Jacobi for higher orders) —
  the *additive* two-level form costs ZERO extra fine matvecs per CG
  iteration, unlike a multiplicative V-cycle (2 extra fine matvecs each).
* ``P``: piecewise-constant prolongation into the fine P_0 mode (higher modes
  untouched — the coarse space only needs the smooth components); ``P^T`` is
  the exact transpose (sum over child cells of the mode-0 residual), so the
  correction term is E^T p_k E with p_k SPD => SPD.
* ``E_f = diag(S_fine)^{1/2}`` / ``E_c = diag(S_c)^{-1/2}``: the solves run on
  symmetrically equilibrated systems (power.group_solve), so the correction
  maps equilibrated-fine residual -> unscaled -> coarse-equilibrated and back.
* the coarse inverse, two interchangeable SPD forms:

  - ``mode="dense"`` (default): the EXACT equilibrated coarse inverse
    ``Minv = inv(E_c S_c E_c)``, materialized once at build time (vmapped
    matvec against the identity + one SPD Cholesky solve) and applied as ONE
    batched matmul per CG iteration, stored bfloat16 when the solve dtype is
    f32 (same law as ``precond_blk_inv``).  The coarse problem is small, so
    its cost is one pass over ~n_c² bytes: at the richest dense-affordable
    coarsening of the 3D benchmark meshes (19³ = 6859 cells, n_c² bf16 =
    94 MB) that read is 24x the fine flux array at 988k cells, while the
    inners/outer it cuts are few (31.4→24.1 / 43→37.1 / 47→42.3 at
    988k/2.6M/3.5M: the adaptive inner tolerance already keeps 3D inner
    counts at 31-47, so a perfect correction could save at most ~25%).
  - ``mode="cheby"``: degree-k Chebyshev polynomial p_k(S_c_eq) on
    [lmax/kappa, lmax] — a fixed-degree polynomial in an SPD operator is
    itself SPD, unlike a nested CG solve which would make the preconditioner
    nonlinear and break CG.  lmax is estimated per group by power iteration at
    build time; each application costs k coarse Schur matvecs, ~100 tiny
    kernels each at coarse shapes, so its cost is kernel latency even though
    it cuts inner iterations 24-48%.  Kept for coarse sizes beyond the dense
    cap.

* The coarse operator is the REDISCRETIZED RT0-P0 Schur on volume-averaged XS
  (coarsen_xs), not a Galerkin triple product: for piecewise-constant coarse
  spaces on tensor meshes the two agree to the usual mixed-FEM averaging error,
  and rediscretization reuses build_context verbatim (factors built once).

Under spatial sharding the correction declines (group_solve falls back to the
fine preconditioner alone — same fixed point, only iteration counts change).

In 3D the two-grid correction stays OPT-IN (NEUTFEM_PRECOND=twogrid; dense
mode default) and the solver default stays jacobi/line: Chebyshev-accelerated
outers + adaptive inner tolerance keep 3D inners/outer at 31-47, so the largest
possible win from ANY coarse correction (even a free one) is a 24-48% inner
cut, which the correction's own cost has to undercut.  The fine 2D cores run
100-330 inners/outer, and there the compat layer attaches it automatically
(``auto_twogrid``).  Both decisions date from before the GPU and are to be
measured again on it (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .fespace import FESpace, make_fespace
from .mesh import CartesianMesh

__all__ = ["attach_twogrid", "auto_twogrid", "coarse_fespace",
           "twogrid_correction", "default_tg_factors", "dense_tg_factors"]

#: 2D auto rule: on the fine 2D cores the dense correction cuts inners/outer
#: by roughly half (KOEBERG 16x16 105.8 -> 44.1, 32x32 209.8 -> 112.8; ZION
#: 48x48 244.9 -> 146.4) and outers 34 -> 28-30, with k shifts < 1 pcm (f32
#: level).  3D stays off (31-47 inners/outer leave it nothing to win).  The
#: 64k-cell threshold is to be measured again on the GPU (ROADMAP.md).
AUTO_TG_MIN_CELLS = 65536


def auto_twogrid(mesh: "CartesianMesh") -> bool:
    """True when the auto preconditioner rule wants the dense two-grid
    correction attached: 2D meshes of >= ~64k cells with a dense-affordable
    coarsening (see AUTO_TG_MIN_CELLS; 3D stays off).  The compat layer calls
    this; core users attach explicitly via attach_twogrid."""
    return (mesh.dim <= 2 and mesh.n_elements >= AUTO_TG_MIN_CELLS
            and dense_tg_factors(mesh, DENSE_MAX_NC) != (1, 1, 1))


def default_tg_factors(mesh: CartesianMesh, max_factor: int = 4) -> Tuple[int, int, int]:
    """Largest factor <= max_factor dividing each active axis (same convention as
    coarse.default_coarse_factors; factor 4 keeps the coarse matvec at ~1/64 of
    the fine cost in 3D so a degree-8 Chebyshev costs ~1/8 fine matvec)."""
    from .coarse import default_coarse_factors

    return default_coarse_factors(mesh, max_factor)


def dense_tg_factors(mesh: CartesianMesh, dense_max: int) -> Tuple[int, int, int]:
    """Smallest coarsening whose coarse cell count fits the dense cap — i.e. the
    RICHEST coarse space whose exact inverse is still affordable (storage is
    n_c² per group; the benchmark meshes all land on 19³ = 6859 because every
    axis is {114, 152} = {6, 8}·19).  Returns (1,1,1) when nothing fits."""
    from .coarse import default_coarse_factors

    nz, ny, nx = mesh.shape
    for max_factor in (2, 3, 4, 6, 8, 12, 16, 24, 32):
        f = default_coarse_factors(mesh, max_factor)
        fx, fy, fz = f
        if all(v == 1 for v in f):
            continue
        if (nx // fx) * (ny // fy) * (nz // fz) <= dense_max:
            return f
    return (1, 1, 1)


def coarse_fespace(fes: FESpace, factors: Tuple[int, int, int]) -> FESpace:
    """The RT0-P0 space on the subsampled mesh (static / trace-time)."""
    mesh = fes.mesh
    fx, fy, fz = factors
    xb = mesh.x_breaks[::fx]
    yb = mesh.y_breaks[::fy] if mesh.dim >= 2 else None
    zb = mesh.z_breaks[::fz] if mesh.dim == 3 else None
    return make_fespace(CartesianMesh.from_breaks(xb, yb, zb), 0, 0)


def _estimate_lmax(cfes: FESpace, cctx: Dict, ng: int, dtype, iters: int = 30):
    """Per-group largest eigenvalue of the equilibrated coarse Schur, by power
    iteration (build-time, one jit).  Returned with a 5% safety margin so the
    Chebyshev interval upper end bounds the true spectrum."""
    from .ops.apply import schur_matvec

    sdi = jnp.sqrt(cctx["precond_inv"])  # (ng, 1, nz, ny, nx)

    def matvec(v):
        return sdi * schur_matvec(cfes, cctx, v * sdi, a_mode="exact")

    def step(v, _):
        w = matvec(v)
        nrm = jnp.sqrt(jnp.sum(w * w, axis=(-4, -3, -2, -1), keepdims=True))
        return w / jnp.maximum(nrm, jnp.finfo(dtype).tiny), nrm

    @jax.jit
    def run(v0):
        v, nrms = jax.lax.scan(step, v0, None, length=iters)
        return nrms[-1].reshape(ng)

    key_free = jnp.arange(np.prod(sdi.shape), dtype=dtype).reshape(sdi.shape)
    v0 = jnp.ones(sdi.shape, dtype) + 0.01 * jnp.sin(key_free)  # deterministic, non-smooth
    return run(v0) * 1.05


DENSE_MAX_NC = 8192  # default dense-inverse cap (n_c² bf16 per group = 128 MB at the cap)


def attach_twogrid(
    fes: FESpace,
    ng: int,
    xs: Dict[str, np.ndarray],
    bcs,
    ctx: Dict,
    factors: Tuple[int, int, int] = None,
    dtype=None,
    marshak_d_factor: bool = False,
    mode: str = "dense",
    dense_max: int = DENSE_MAX_NC,
) -> Dict:
    """Build the coarse context + coarse inverse and attach them as ctx["tg"].

    The nested dict holds a full build_context output (so power.ctx_group can
    recurse into it with the same key-prefix rules) plus EITHER
    "schur_minv" (ng, n_c, n_c) — the dense equilibrated coarse inverse,
    bfloat16 when the solve dtype is f32 — OR "schur_lmax" (ng,) for the
    Chebyshev form.  ``mode="dense"`` falls back to Chebyshev when the coarse
    cell count exceeds ``dense_max`` (explicitly passed factors are honored;
    default factor selection picks the richest dense-affordable coarsening).
    """
    from .coarse import coarsen_xs
    from .ops.context import build_context

    mesh = fes.mesh
    if factors is None:
        factors = (dense_tg_factors(mesh, dense_max) if mode == "dense"
                   else default_tg_factors(mesh))
        if all(f == 1 for f in factors) and mode == "dense":
            factors = default_tg_factors(mesh)  # nothing dense-affordable
    if all(f == 1 for f in factors):
        return ctx  # no coarsening possible — leave ctx untouched (declines)
    cmesh, cxs = coarsen_xs(mesh, xs, factors)
    cfes = make_fespace(cmesh, 0, 0)
    cctx = build_context(cfes, ng, cxs, bcs, a_mode="exact", dtype=dtype,
                         marshak_d_factor=marshak_d_factor)
    n_c = int(np.prod(cmesh.shape))
    if mode == "dense" and n_c <= dense_max:
        minv = _dense_coarse_inv(cfes, cctx, ng)
        store_dt = jnp.bfloat16 if minv.dtype == jnp.float32 else minv.dtype
        ctx["tg"] = {**cctx, "schur_minv": minv.astype(store_dt)}
    else:
        lmax = _estimate_lmax(cfes, cctx, ng, dtype or ctx["C"].dtype)
        ctx["tg"] = {**cctx, "schur_lmax": lmax}
    return ctx


def _dense_coarse_inv(cfes: FESpace, cctx: Dict, ng: int):
    """(ng, n_c, n_c) exact inverse of the equilibrated coarse Schur
    Ŝ_c = E_c S_c E_c (unit diagonal — the same sdi_c scaling the correction
    applies at run time), materialized per group by the vmapped matrix-free
    matvec against the identity (ops/direct.py machinery) + one SPD
    Cholesky solve against the identity.  Build-time only."""
    from jax.scipy.linalg import cho_solve

    from .ops.direct import dense_schur_group
    from .power import ctx_group

    mats = []
    for g in range(ng):
        cg = ctx_group(cctx, g)
        S = dense_schur_group(cfes, cg, "exact")
        sdi = jnp.sqrt(cg["precond_inv"]).reshape(-1)
        shat = S * sdi[:, None] * sdi[None, :]
        eye = jnp.eye(shat.shape[0], dtype=shat.dtype)
        chol = jnp.linalg.cholesky(shat)
        mats.append(0.5 * (lambda m: m + m.T)(cho_solve((chol, True), eye)))
    return jnp.stack(mats)


def tg_factors_of(fes: FESpace, ctx_tg: Dict) -> Tuple[int, int, int]:
    """(fx, fy, fz) recovered statically from the coarse array shapes."""
    nzc, nyc, nxc = ctx_tg["C"].shape[-3:]
    nz, ny, nx = fes.mesh.shape
    return nx // nxc, ny // nyc, nz // nzc


def _axis_restrictor(n_f: int, f: int, dtype):
    """(n_f, n_c) 0/1 child-to-parent aggregation matrix for one axis.

    Restriction contracts the FINE index (``einsum('...x,xc->...c')``),
    prolongation contracts the COARSE index (``einsum('...c,xc->...x')``) —
    exact transposes of each other, so the two-grid term stays SPD.  Built as
    a trace-time constant (tiny: n_f x n_c).
    """
    idx = np.arange(n_f)[:, None] // f == np.arange(n_f // f)[None, :]
    return jnp.asarray(idx.astype(dtype))


def twogrid_correction(fes: FESpace, ctxg: Dict, opts, r):
    """The coarse-correction term  E_f P E_c p_k(S_c_eq) E_c P^T E_f r.

    ``r`` is the equilibrated fine residual, internal layout
    (..., P, nz, ny, nx); ``ctxg`` may be group-sliced (GS sweep) or carry a
    leading group axis (batched Jacobi sweep) — every step broadcasts.
    Returns the correction in the same shape (caller adds the fine-level part).

    Restriction/prolongation are PER-AXIS MATMULS against 0/1 aggregation
    matrices, NOT reshape-and-sum: splitting the minor dim into
    (coarse, factor) pairs relayouts the whole fine array on every
    application, while the dot form keeps the fine minor dim intact until the
    final (cheap) x contraction.  Order restrict z,y,x / prolong x,y,z so every
    fine-sized intermediate keeps the fine x axis minor.
    """
    tg = ctxg["tg"]
    factors = tg_factors_of(fes, tg)
    fx, fy, fz = factors
    cfes = coarse_fespace(fes, factors)
    nz, ny, nx = fes.mesh.shape

    inv_sdi_f = 1.0 / jnp.sqrt(ctxg["precond_inv"])     # E_f = diag(S_f)^{1/2}
    sdi_c = jnp.sqrt(tg["precond_inv"])                  # E_c = diag(S_c)^{-1/2}

    dt = r.dtype
    Rz = _axis_restrictor(nz, fz, dt)
    Ry = _axis_restrictor(ny, fy, dt)
    Rx = _axis_restrictor(nx, fx, dt)

    # restrict: mode-0 plane, unscale, per-axis child sums (z, y, then x)
    r0 = (r * inv_sdi_f)[..., 0, :, :, :]
    rc = jnp.einsum("...zyx,zc->...cyx", r0, Rz)
    rc = jnp.einsum("...zyx,yc->...zcx", rc, Ry)
    rc = jnp.einsum("...zyx,xc->...zyc", rc, Rx)
    rc = rc[..., None, :, :, :] * sdi_c                  # (..., 1, nzc, nyc, nxc)

    minv = tg.get("schur_minv")
    if minv is not None:
        # dense mode: ONE batched matmul against the precomputed equilibrated
        # coarse inverse (bf16 storage when the solve is f32 — same law as
        # precond_blk_inv; as a preconditioner ~3-digit accuracy is plenty)
        s = rc.shape  # (..., 1, nzc, nyc, nxc); possibly leading ng
        rflat = rc.reshape(*s[:-4], -1).astype(minv.dtype)
        if minv.ndim == 3:  # batched Jacobi sweep: leading group axis
            zflat = jnp.einsum("gij,gj->gi", minv, rflat)
        else:  # group-sliced GS sweep
            zflat = minv @ rflat
        zc = zflat.astype(rc.dtype).reshape(s)
    else:
        # degree-k Chebyshev approximate inverse of the equilibrated coarse
        # Schur on [lmax/kappa, lmax] (three-term recurrence; z0 = 0, k matvecs)
        from .ops.apply import schur_matvec

        lmax = tg["schur_lmax"]
        if lmax.ndim == 1:  # batched (leading ng): broadcast over (1, nz, ny, nx)
            lmax = lmax.reshape(-1, 1, 1, 1, 1)
        lmin = lmax / opts.tg_kappa
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta

        def matvec(v):
            return sdi_c * schur_matvec(cfes, tg, v * sdi_c, a_mode="exact")

        d = rc / theta
        zc = d
        res = rc - matvec(d)
        rho = 1.0 / sigma
        for _ in range(max(opts.tg_degree - 1, 0)):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
            zc = zc + d
            res = res - matvec(d)
            rho = rho_new

    # prolong: coarse-equilibrate back, replicate into the fine P_0 mode
    # (transposed per-axis dots: x first so fine-sized intermediates keep the
    # 128-lane x axis), rescale
    zc = (zc * sdi_c)[..., 0, :, :, :]
    z0 = jnp.einsum("...zyc,xc->...zyx", zc, Rx)
    z0 = jnp.einsum("...zcx,yc->...zyx", z0, Ry)
    z0 = jnp.einsum("...cyx,zc->...zyx", z0, Rz)
    out = jnp.zeros_like(r)
    out = out.at[..., 0, :, :, :].set(z0)
    return out * inv_sdi_f
