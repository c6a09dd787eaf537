"""Global numerical configuration for neutfem_jax.

The reference implementation (C++/Eigen) computes everything in
float64 (``include/FEM.hpp:30-37`` uses ``double`` throughout).  We keep the
*working* dtype configurable:

* ``NEUTFEM_X64=1`` (default): enable JAX x64 and solve in float64 — bit-faithful to
  the reference math, required for sub-pcm eigenvalue agreement out of the box.
* ``NEUTFEM_X64=0``: leave JAX in float32 mode.  The power iteration then runs in
  float32 (the equilibrated Schur CG keeps it within ~0.05 pcm of float64 —
  tests/test_precision.py).

This module must be imported before any other JAX work in the package.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

_X64 = os.environ.get("NEUTFEM_X64", "1") not in ("0", "false", "False")

if _X64:
    jax.config.update("jax_enable_x64", True)

# Matmul precision: on the GPU, JAX's DEFAULT lets float32 contractions run in
# TF32 (10-bit mantissa).  Every higher-order (P > 1) hot-path op here is a SMALL
# einsum (B/B^T mode contractions, bubble condensation, PxP block-Jacobi applies)
# whose operand dims are <= ~9 — tensor-core time is negligible but the reduced
# mantissa is not: it floors the outer flux difference near 1e-3 at scale, where
# true f32 converges the same problems to dphi < 1e-5.  HIGHEST keeps these
# contractions in full f32.  Override with NEUTFEM_MATMUL_PRECISION=default.
_prec = os.environ.get("NEUTFEM_MATMUL_PRECISION", "highest")
if _prec not in ("", "default"):
    jax.config.update("jax_default_matmul_precision", _prec)

#: Persistent compilation cache used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: a fixed directory inside the checkout (git-ignored), so a second process finds
#: the large jitted power-iteration loops already compiled.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str:
    """The persistent compilation cache directory in use."""
    return jax.config.jax_compilation_cache_dir or ""


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    # where the variable is set, JAX reads it itself and nothing is set here
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))

import jax.numpy as jnp  # noqa: E402  (after x64 flag)

#: Working dtype for all solver arrays.
real_dtype = jnp.float64 if _X64 else jnp.float32

#: Index dtype.
index_dtype = jnp.int32


def x64_enabled() -> bool:
    return _X64


def set_x64(enabled: bool) -> None:
    """Switch the working dtype at runtime (before building any solver).

    Needed because ``python -m benchmarks.<tool>`` imports the ``benchmarks``
    package (→ this module) BEFORE the tool's own module code runs, so setting
    ``NEUTFEM_X64`` at the tool's module top is already too late.  All package
    code reads ``config.real_dtype`` by attribute, so flipping it here is safe
    as long as no solver arrays exist yet."""
    global _X64, real_dtype
    _X64 = bool(enabled)
    jax.config.update("jax_enable_x64", _X64)
    real_dtype = jnp.float64 if _X64 else jnp.float32
