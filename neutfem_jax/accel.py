"""Fixed-point accelerators for the power iteration, as functional JAX state.

* Chebyshev semi-iterative acceleration — faithful port of the reference recurrence
  (``/root/reference/src/solvers.cpp:664-756``):

      gamma = acosh(2/sigma - 1)
      a_1   = 2 / (2 - sigma)
      a_n   = cosh((n-1) gamma) / cosh(n gamma),  b_n = cosh((n-2) gamma) / cosh(n gamma)

      n = 0: store phi_0
      n = 1: phi <- phi_0 + a_1 (phi - phi_0)
      n >= 2: phi <- phi_1 + (4/sigma) a_n (phi - phi_1) + b_n (phi_1 - phi_0)

  with automatic reset after ``nmax`` applications.  Instantiated by the solver as
  ``ChebyshevAccel(15, 0.98)`` like the reference (NeutFEM.cpp:1673, 1897).

* Anderson mixing — the reference ships it as dead code (solvers.cpp:772-891, never
  instantiated) but advertises it; here it is a first-class accelerator: window-``m``
  least-squares on residual differences with Tikhonov regularization and relative-step
  clipping, expressed with fixed-shape history buffers so it jits.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ChebyshevState",
    "chebyshev_init",
    "chebyshev_apply",
    "chebyshev_apply_blend",
    "AndersonState",
    "anderson_init",
    "anderson_apply",
]


class ChebyshevState(NamedTuple):
    it: jnp.ndarray    # applications since last reset
    phi0: jnp.ndarray  # accelerated iterate n-2
    phi1: jnp.ndarray  # accelerated iterate n-1


def chebyshev_coeffs(nmax: int, sigma: float) -> Tuple[np.ndarray, np.ndarray]:
    g = np.arccosh(2.0 / sigma - 1.0)
    n = np.arange(nmax, dtype=np.float64)
    with np.errstate(over="ignore"):
        a = np.cosh((n - 1) * g) / np.cosh(n * g)
        b = np.cosh((n - 2) * g) / np.cosh(n * g)
    a[0], b[0] = 0.0, 0.0
    if nmax > 1:
        a[1] = 2.0 / (2.0 - sigma)
        b[1] = 0.0
    return a, b


def chebyshev_init(phi_like) -> ChebyshevState:
    z = jnp.zeros_like(phi_like)
    return ChebyshevState(it=jnp.asarray(0, jnp.int32), phi0=z, phi1=z)


def chebyshev_apply(state: ChebyshevState, phi, nmax: int = 15, sigma: float = 0.98):
    """One accelerator application. Returns (new_state, accelerated_phi)."""
    a_np, b_np = chebyshev_coeffs(nmax, sigma)
    a = jnp.asarray(a_np, dtype=phi.dtype)
    b = jnp.asarray(b_np, dtype=phi.dtype)

    it = jnp.where(state.it == nmax, 0, state.it)

    def case0(_):
        return ChebyshevState(it + 1, phi, phi), phi

    def case1(_):
        acc = state.phi0 + a[1] * (phi - state.phi0)
        return ChebyshevState(it + 1, state.phi0, acc), acc

    def case2(_):
        an = a[jnp.clip(it, 0, nmax - 1)]
        bn = b[jnp.clip(it, 0, nmax - 1)]
        acc = state.phi1 + (4.0 / sigma) * an * (phi - state.phi1) + bn * (
            state.phi1 - state.phi0
        )
        return ChebyshevState(it + 1, state.phi1, acc), acc

    branch = jnp.clip(it, 0, 2)
    return jax.lax.switch(branch, [case0, case1, case2], None)


def chebyshev_apply_blend(
    state: ChebyshevState, phi, apply, nmax: int = 15, sigma: float = 0.98
):
    """Branch-free ``chebyshev_apply``, gated by the traced scalar ``apply``.

    ``lax.cond``/``lax.switch`` over flux-sized operands materialize every branch
    tuple in device memory (copy-in/copy-out), a flux-sized copy per operand
    per outer.  All three recurrence cases share the shape

        acc = base + s1 * (phi - base) + s2 * (phi1 - phi0)

    with case-selected scalars (case 0: base=phi, s1=s2=0; case 1: base=phi0,
    s1=a_1; case >= 2: base=phi1, s1=(4/sigma) a_n, s2=b_n), so one masked-scalar
    evaluation replaces the control flow and XLA fuses it into the surrounding
    elementwise chain.  ``apply=False`` folds to acc=phi / state unchanged.
    Arithmetic per case is ASSOCIATED IDENTICALLY to ``chebyshev_apply``.
    """
    a_np, b_np = chebyshev_coeffs(nmax, sigma)
    a = jnp.asarray(a_np, dtype=phi.dtype)
    b = jnp.asarray(b_np, dtype=phi.dtype)

    apply = jnp.asarray(apply)
    it = jnp.where(state.it == nmax, 0, state.it)
    case = jnp.clip(it, 0, 2)
    an = a[jnp.clip(it, 0, nmax - 1)]
    bn = b[jnp.clip(it, 0, nmax - 1)]

    s1 = jnp.where(case == 1, a[1], (4.0 / sigma) * an)
    s1 = jnp.where(apply, jnp.where(case == 0, 0.0, s1), 0.0).astype(phi.dtype)
    s2 = jnp.where(apply & (case == 2), bn, 0.0).astype(phi.dtype)
    use0 = apply & (case == 1)
    use1 = apply & (case == 2)
    base = jnp.where(use0, state.phi0, jnp.where(use1, state.phi1, phi))

    acc = base + s1 * (phi - base) + s2 * (state.phi1 - state.phi0)

    phi0_new = jnp.where(apply, base, state.phi0)
    phi1_new = jnp.where(apply, acc, state.phi1)
    it_new = jnp.where(apply, it + 1, state.it)
    return ChebyshevState(it_new, phi0_new, phi1_new), acc


class AndersonState(NamedTuple):
    it: jnp.ndarray      # number of (x, g(x)) pairs seen
    X: jnp.ndarray       # (m, n) history of iterates x_j (flattened)
    F: jnp.ndarray       # (m, n) history of residuals f_j = g(x_j) - x_j


def anderson_init(n: int, m: int, dtype) -> AndersonState:
    return AndersonState(
        it=jnp.asarray(0, jnp.int32),
        X=jnp.zeros((m, n), dtype=dtype),
        F=jnp.zeros((m, n), dtype=dtype),
    )


def anderson_apply(
    state: AndersonState,
    x_prev,
    gx,
    beta: float = 1.0,
    reg: float = 1e-8,
    max_rel: float = 0.3,
):
    """Anderson(m) update given previous iterate x_prev and fixed-point image gx.

    Matches the reference algorithm (solvers.cpp:772-891): least squares on residual
    differences with Tikhonov ``reg``, mixing parameter ``beta``, and the correction
    clipped to ``max_rel`` relative norm.  Returns (new_state, x_next) flattened.
    """
    m = state.X.shape[0]
    x_prev = x_prev.reshape(-1)
    gx = gx.reshape(-1)
    f = gx - x_prev

    # ring-buffer push (newest at slot it % m); we keep insertion order via rolling
    X = jnp.roll(state.X, -1, axis=0).at[-1].set(x_prev)
    F = jnp.roll(state.F, -1, axis=0).at[-1].set(f)
    it = state.it + 1

    k = jnp.minimum(it, m)  # valid history length

    # differences over the valid window: dF_j = F[j+1] - F[j]
    dF = F[1:] - F[:-1]          # (m-1, n)
    dX = X[1:] - X[:-1]
    # valid mask: last (k-1) difference rows
    idx = jnp.arange(m - 1)
    valid = (idx >= (m - 1) - (k - 1)).astype(x_prev.dtype)
    dF = dF * valid[:, None]
    dX = dX * valid[:, None]

    # solve (dF dF^T + reg I) theta = dF f
    G = dF @ dF.T + reg * jnp.eye(m - 1, dtype=x_prev.dtype)
    rhs = dF @ f
    theta = jnp.linalg.solve(G, rhs)

    correction = theta @ (dX + dF)
    x_acc = x_prev + beta * f - correction

    # clip correction to max_rel relative to ||x||
    step = x_acc - gx
    step_norm = jnp.linalg.norm(step)
    x_norm = jnp.linalg.norm(gx)
    scale = jnp.minimum(1.0, max_rel * x_norm / jnp.where(step_norm == 0, 1.0, step_norm))
    x_acc = gx + scale * step

    # need >= 2 samples for a meaningful update
    x_next = jnp.where(it >= 2, x_acc, gx)
    return AndersonState(it=it, X=X, F=F), x_next
