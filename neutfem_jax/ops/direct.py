"""Explicit (dense) Schur complement + direct factorization.

Analogue of the reference's explicit-Schur path
(``/root/reference/src/solvers.cpp:259-427``): ``SchurSolver::SetMatrices`` forms
``S = C + B A^{-1} B^T`` column-by-column and hands it to a direct Eigen solver
(SparseLU / SimplicialLDLT / SimplicialLLT) whenever a DIRECT_* ``LinearSolverType``
is selected (or n_phi < 200).  Here the same thing is done on the device:

* S is materialized by a vmapped application of the matrix-free ``schur_matvec``
  to the identity — one batched pass, no triplet scatter;
* the factorization is a Cholesky of the symmetrically Jacobi-equilibrated
  ``Ŝ = D^{-1/2} S D^{-1/2}`` (unit diagonal ⇒ float32-safe even with the 1e15
  near-void Σr fillers of the IAEA-3D / KOEBERG benchmarks);
* each group solve is then two batched triangular solves inside the jitted
  power iteration — no Krylov loop at all.

Dense S is O(n_phi²) memory, so this path is gated to n_phi ≤
``NEUTFEM_DIRECT_MAX_NPHI`` (default 4096; 4096² f32 = 64 MB per group).  Above
the gate the compat layer falls back to the equilibrated CG with a
RuntimeWarning — there is no on-device analogue of a scalable sparse LU, and the
matrix-free CG is the design-intended solver at scale (SURVEY §7.1).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

__all__ = ["attach_dense_schur", "direct_solve", "DIRECT_MAX_NPHI"]

DIRECT_MAX_NPHI = 4096  # default gate; override via NEUTFEM_DIRECT_MAX_NPHI


def dense_schur_group(fes, ctxg: Dict, a_mode: str):
    """Materialize the (n_phi, n_phi) Schur complement of ONE group by applying
    the matrix-free ``schur_matvec`` to the identity basis (batched via vmap)."""
    from .apply import schur_matvec

    shape = (fes.P, *fes.mesh.shape)  # internal mode-first layout
    n = 1
    for s in shape:
        n *= s
    dtype = ctxg["C"].dtype
    eye = jnp.eye(n, dtype=dtype)

    def col(e):
        # fused=False: keep every Pallas kernel out of the vmap (their batching
        # rule is not exercised by the tests); the plain ops are plenty for
        # n_phi <= 4096.
        return schur_matvec(fes, ctxg, e.reshape(shape), a_mode=a_mode,
                            fused=False).reshape(-1)

    S = jax.vmap(col)(eye)  # row i = S e_i ; S symmetric
    return 0.5 * (S + S.T)  # enforce exact symmetry for the Cholesky


@jax.jit
def _equilibrated_cholesky(S):
    d = jnp.diagonal(S)
    sdi = 1.0 / jnp.sqrt(jnp.where(d <= 0, 1.0, d))
    S_hat = S * sdi[:, None] * sdi[None, :]
    L = jnp.linalg.cholesky(S_hat)
    return L, sdi


def attach_dense_schur(fes, ctx: Dict, a_mode: str) -> None:
    """Build per-group dense Schur factors and store them in ctx (idempotent).

    Adds ``schur_chol`` (ng, n, n) and ``schur_sdi`` (ng, n) — the ``schur_``
    prefix is group-sliced by ``power.ctx_group``."""
    if "schur_chol" in ctx:
        return
    ng = ctx["C"].shape[0]
    from ..power import ctx_group

    Ls, sdis = [], []
    for g in range(ng):
        S = dense_schur_group(fes, ctx_group(ctx, g), a_mode)
        L, sdi = _equilibrated_cholesky(S)
        Ls.append(L)
        sdis.append(sdi)
    ctx["schur_chol"] = jnp.stack(Ls)
    ctx["schur_sdi"] = jnp.stack(sdis)


def direct_solve(ctxg: Dict, rhs):
    """x = S^{-1} rhs from the precomputed equilibrated Cholesky factors.

    Solves Ŝ y = D^{-1/2} rhs, then x = D^{-1/2} y (two triangular solves).
    Handles both a single group (L: (n,n)) and the batched Jacobi sweep
    (L: (ng,n,n), rhs carrying a leading group axis)."""
    L = ctxg["schur_chol"]
    sdi = ctxg["schur_sdi"]
    if L.ndim == 3:
        b = (rhs.reshape(L.shape[0], -1) * sdi)[..., None]
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        y = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(L, -1, -2), y, lower=False
        )[..., 0]
    else:
        b = rhs.reshape(-1) * sdi
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        y = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    return (y * sdi).reshape(rhs.shape)
