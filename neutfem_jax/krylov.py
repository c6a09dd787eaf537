"""Krylov solvers in ``lax.while_loop`` form (fully on-device, no host round-trips).

Replacement for the reference's Eigen solver zoo and its hand-written
unpreconditioned implicit-Schur CG (``/root/reference/src/solvers.cpp:577-636``).  The
Schur complement is SPD, so preconditioned CG is the workhorse; BiCGSTAB is provided for
API parity with ``LinearSolverType`` (solvers.hpp:176-190) and for non-symmetric
operators.

Stopping rule matches the reference: ``||r||^2 < tol^2 ||b||^2`` (solvers.cpp:592, 620).
Operands can be arbitrary pytrees; dot products reduce over everything.

Two CG implementations:

* ``pcg`` — textbook PCG (three separate dot products per iteration).
* ``pcg_fused`` — the Chronopoulos-Gear single-reduction variant: per iteration ONE
  fused multi-result reduction (a variadic ``lax.reduce``) produces every dot product
  the recurrences need, reading each operand exactly once; this removes two of the
  three reduction kernels per iteration.  Same fixed point; the alpha recurrence is
  algebraically identical in exact arithmetic (Chronopoulos & Gear 1989).  Opt-in
  via NEUTFEM_CGCG=1: it adds two axpys of device-memory traffic per iteration.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["pcg", "pcg_fused", "bicgstab", "KrylovResult"]


def _dot(a, b):
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(jnp.vdot(x, y) for x, y in zip(leaves_a, leaves_b))


def _dots(*pairs):
    """k dot products in ONE pass: a single variadic ``lax.reduce`` per leaf computes
    every requested ``Re<x, y>`` together, so XLA emits one fused reduction kernel
    reading each distinct operand once (vs one kernel per jnp.vdot).  Matches
    ``_dot(x, y).real`` exactly (conjugated first operand, real result) so the
    documented complex-pytree support survives — for real dtypes conj/real are
    no-ops XLA elides."""
    leaf_pairs = [tuple(zip(jax.tree_util.tree_leaves(x), jax.tree_util.tree_leaves(y)))
                  for (x, y) in pairs]
    n_leaves = len(leaf_pairs[0])
    total = None
    for i in range(n_leaves):
        prods = tuple((lp[i][0].conj() * lp[i][1]).real for lp in leaf_pairs)
        dtype = prods[0].dtype
        zeros = (jnp.zeros((), dtype),) * len(prods)
        part = lax.reduce(
            prods, zeros,
            lambda acc, val: tuple(a + v for a, v in zip(acc, val)),
            tuple(range(prods[0].ndim)),
        )
        total = part if total is None else tuple(t + p for t, p in zip(total, part))
    return total


def _axpy(alpha, x, y):
    return jax.tree_util.tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def _breakdown_tiny(dtype):
    """Smallest magnitude a breakdown denominator may legally have.  The reference
    guards with an absolute ``1e-30`` in double (solvers.cpp:605); a literal like
    1e-300 underflows to 0.0 in float32 so the guard could never fire on the very
    path (f32) it protects — use the dtype's own tiny instead."""
    return jnp.asarray(jnp.finfo(dtype).tiny, dtype)


class KrylovResult(NamedTuple):
    x: object
    iterations: jnp.ndarray
    residual: jnp.ndarray  # ||r|| / ||b||


def pcg(
    matvec: Callable,
    rhs,
    x0,
    precond: Optional[Callable] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
) -> KrylovResult:
    """Preconditioned conjugate gradient on an SPD operator (textbook loop).

    With ``precond=None`` the identity preconditioner is specialized away: no z
    vector and no separate r.z reduction (rz == rr)."""
    identity_pc = precond is None
    if identity_pc:
        precond = lambda r: r

    b_norm_sq = _dot(rhs, rhs).real
    tol_sq = tol * tol * b_norm_sq
    # b = 0 has the unique solution x = 0, but a nonzero warm start makes the
    # relative stopping rule ||r||^2 < tol^2 ||b||^2 = 0 unreachable (runs to
    # maxiter; NaNs in f32).  The reference never hits this
    # (it cold-starts from zero, solvers.cpp:585); we warm-start, so guard.
    zero_rhs = b_norm_sq == 0.0

    r0 = jax.tree_util.tree_map(lambda b, ax: b - ax, rhs, matvec(x0))
    rr0 = _dot(r0, r0).real
    if identity_pc:
        z0, rz0 = r0, rr0
    else:
        z0 = precond(r0)
        rz0 = _dot(r0, z0).real
    tiny = _breakdown_tiny(rr0.dtype)

    def cond(state):
        _, _, _, _, rr, _, it, brk = state
        return (it < maxiter) & (rr > tol_sq) & (~brk) & (~zero_rhs)

    def body(state):
        x, r, z, p, rr, rz, it, _ = state
        q = matvec(p)
        pq = _dot(p, q).real
        breakdown = jnp.abs(pq) <= tiny
        alpha = rz / jnp.where(breakdown, 1.0, pq)
        alpha = jnp.where(breakdown, 0.0, alpha)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, q, r)
        if identity_pc:
            rr_new = _dot(r, r).real
            z, rz_new = r, rr_new
        else:
            z = precond(r)
            rz_new, rr_new = _dots((r, z), (r, r))
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        p = _axpy(beta, p, z)
        return (x, r, z, p, rr_new, rz_new, it + 1, breakdown)

    x, r, _, _, rr, _, it, _ = lax.while_loop(
        cond, body,
        (x0, r0, z0, z0, rr0, rz0, jnp.asarray(0, dtype=jnp.int32),
         jnp.asarray(False)),
    )
    x = jax.tree_util.tree_map(lambda xi: jnp.where(zero_rhs, 0.0, xi), x)
    rr = jnp.where(zero_rhs, 0.0, rr)
    denom = jnp.sqrt(jnp.where(b_norm_sq == 0.0, 1.0, b_norm_sq))
    return KrylovResult(x=x, iterations=it, residual=jnp.sqrt(rr) / denom)


def pcg_fused(
    matvec: Callable,
    rhs,
    x0,
    precond: Optional[Callable] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
) -> KrylovResult:
    """Chronopoulos-Gear PCG: one fused reduction per iteration.

    Recurrence (u = M r, w = A u):

        p <- u + beta p;  s <- w + beta s
        x <- x + alpha p; r <- r - alpha s
        u <- M r;         w <- A u
        gamma' = (r, u);  delta = (w, u)   [+ rr = (r, r) when M != I]
        beta = gamma'/gamma
        alpha = gamma' / (delta - beta gamma' / alpha)

    All dot products come out of ONE variadic reduce (``_dots``), so the loop body
    has a single reduction kernel; with the identity preconditioner gamma == rr and
    the reduce has two results (r.r and w.r) instead of three.
    Stopping rule identical to ``pcg`` (reference solvers.cpp:592): ||r||^2 on the
    true residual vs tol^2 ||b||^2.
    """
    identity_pc = precond is None
    if identity_pc:
        precond = lambda r: r

    b_norm_sq = _dot(rhs, rhs).real
    tol_sq = tol * tol * b_norm_sq
    zero_rhs = b_norm_sq == 0.0  # see pcg

    r0 = jax.tree_util.tree_map(lambda b, ax: b - ax, rhs, matvec(x0))
    u0 = r0 if identity_pc else precond(r0)
    w0 = matvec(u0)
    if identity_pc:
        gamma0, delta0 = _dots((r0, u0), (w0, u0))
        rr0 = gamma0
    else:
        gamma0, delta0, rr0 = _dots((r0, u0), (w0, u0), (r0, r0))
    tiny = _breakdown_tiny(rr0.dtype)
    brk0 = jnp.abs(delta0) <= tiny
    alpha0 = gamma0 / jnp.where(brk0, 1.0, delta0)
    zero = jax.tree_util.tree_map(jnp.zeros_like, r0)

    def cond(state):
        it, rr, brk = state[6], state[8], state[10]
        return (it < maxiter) & (rr > tol_sq) & (~brk) & (~zero_rhs)

    def body(state):
        x, r, u, w, p, s, it, gamma, rr, alpha, _, beta = state
        p = _axpy(beta, p, u)
        s = _axpy(beta, s, w)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, s, r)
        u = r if identity_pc else precond(r)
        w = matvec(u)
        if identity_pc:
            gamma_new, delta = _dots((r, u), (w, u))
            rr_new = gamma_new
        else:
            gamma_new, delta, rr_new = _dots((r, u), (w, u), (r, r))
        beta_new = gamma_new / jnp.where(gamma == 0.0, 1.0, gamma)
        denom = delta - beta_new * gamma_new / alpha
        breakdown = jnp.abs(denom) <= tiny
        alpha_new = gamma_new / jnp.where(breakdown, 1.0, denom)
        alpha_new = jnp.where(breakdown, 0.0, alpha_new)
        return (x, r, u, w, p, s, it + 1, gamma_new, rr_new, alpha_new,
                breakdown, beta_new)

    state0 = (x0, r0, u0, w0, zero, zero, jnp.asarray(0, jnp.int32),
              gamma0, rr0, jnp.where(brk0, 0.0, alpha0), brk0,
              jnp.zeros_like(gamma0))
    out = lax.while_loop(cond, body, state0)
    x, rr, it = out[0], out[8], out[6]
    x = jax.tree_util.tree_map(lambda xi: jnp.where(zero_rhs, 0.0, xi), x)
    rr = jnp.where(zero_rhs, 0.0, rr)
    denom = jnp.sqrt(jnp.where(b_norm_sq == 0.0, 1.0, b_norm_sq))
    return KrylovResult(x=x, iterations=it, residual=jnp.sqrt(jnp.abs(rr)) / denom)


def bicgstab(
    matvec: Callable,
    rhs,
    x0,
    precond: Optional[Callable] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
) -> KrylovResult:
    """Right-preconditioned BiCGSTAB (works for non-symmetric operators)."""
    if precond is None:
        precond = lambda r: r

    b_norm_sq = _dot(rhs, rhs).real
    tol_sq = tol * tol * b_norm_sq
    zero_rhs = b_norm_sq == 0.0  # see pcg: warm start + zero rhs never converges

    r0 = jax.tree_util.tree_map(lambda b, ax: b - ax, rhs, matvec(x0))
    rhat = r0
    rr0 = _dot(r0, r0).real
    tiny = _breakdown_tiny(rr0.dtype)

    def cond(state):
        _, _, _, _, _, _, _, rr, it, brk = state
        return (it < maxiter) & (rr > tol_sq) & (~brk) & (~zero_rhs)

    def body(state):
        x, r, p, v, rho, alpha, omega, rr, it, brk = state
        rho_new = _dot(rhat, r)
        safe_rho = jnp.where(rho == 0, 1.0, rho)
        safe_omega = jnp.where(omega == 0, 1.0, omega)
        beta = (rho_new / safe_rho) * (alpha / safe_omega)
        p = jax.tree_util.tree_map(lambda ri, pi, vi: ri + beta * (pi - omega * vi), r, p, v)
        phat = precond(p)
        v = matvec(phat)
        rv = _dot(rhat, v)
        alpha_new = rho_new / jnp.where(rv == 0, 1.0, rv)
        s = _axpy(-alpha_new, v, r)
        shat = precond(s)
        t = matvec(shat)
        tt, ts = _dots((t, t), (t, s))
        omega_new = ts.real / jnp.where(tt.real == 0, 1.0, tt.real)
        x = _axpy(alpha_new, phat, _axpy(omega_new, shat, x))
        r = _axpy(-omega_new, t, s)
        rr_new = _dot(r, r).real
        breakdown = (jnp.abs(rho_new) <= tiny) | (tt.real == 0)
        return (x, r, p, v, rho_new, alpha_new, omega_new, rr_new, it + 1, breakdown)

    one = jnp.asarray(1.0, dtype=jnp.result_type(rr0))
    x, r, _, _, _, _, _, rr, it, _ = lax.while_loop(
        cond,
        body,
        (x0, r0, r0, jax.tree_util.tree_map(jnp.zeros_like, r0), one, one, one, rr0,
         jnp.asarray(0, dtype=jnp.int32), jnp.asarray(False)),
    )
    x = jax.tree_util.tree_map(lambda xi: jnp.where(zero_rhs, 0.0, xi), x)
    rr = jnp.where(zero_rhs, 0.0, rr)
    denom = jnp.sqrt(jnp.where(b_norm_sq == 0.0, 1.0, b_norm_sq))
    return KrylovResult(x=x, iterations=it, residual=jnp.sqrt(rr) / denom)
