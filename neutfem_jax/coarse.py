"""Coarse-grid (multigrid-style) initialization of the power iteration.

Rebuild of ``NeutFEM::SolveCoarse`` (reference ``src/NeutFEM.cpp:2380-2611``).
The reference recursively instantiates a second RT0-P0 ``NeutFEM`` object; here it is a
plain function: downsample the XS (volume-weighted arithmetic mean, *including D* —
the reference's comment discusses a harmonic mean but the code uses arithmetic,
NeutFEM.cpp:2475-2478 vs :2543), solve a cheap RT0-P0 eigenproblem on the coarse mesh
with relaxed tolerances (x10, half the outer budget, NeutFEM.cpp:2460-2461), and inject
the coarse flux into the fine P_0 mode (higher modes zero, NeutFEM.cpp:2598-2603).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .bc import BCSpec
from .fespace import FESpace, make_fespace
from .mesh import CartesianMesh
from .ops.context import build_context
from .power import SolveOptions, power_iteration

__all__ = ["coarsen_xs", "coarse_init", "default_coarse_factors"]


def default_coarse_factors(mesh: CartesianMesh, max_factor: int = 4) -> Tuple[int, int, int]:
    """Largest factor <= max_factor dividing each active axis (driver convention,
    reference tests/iaea2d/iaea2d.py:170-181)."""
    out = []
    for n, active in ((mesh.nx, True), (mesh.ny, mesh.dim >= 2), (mesh.nz, mesh.dim == 3)):
        f = 1
        if active:
            for cand in range(min(max_factor, n), 0, -1):
                if n % cand == 0:
                    f = cand
                    break
        out.append(f)
    return tuple(out)


def _block_mean(a: np.ndarray, factors, weights: np.ndarray) -> np.ndarray:
    """Volume-weighted block mean over trailing (nz, ny, nx) axes (native kernel
    when built, numpy otherwise — see neutfem_jax.native)."""
    from .native import block_mean

    return block_mean(a, weights, factors)


def coarsen_xs(mesh: CartesianMesh, xs: Dict[str, np.ndarray], factors) -> Tuple[CartesianMesh, Dict]:
    """Build the coarse mesh (subsampled breakpoints) and volume-averaged XS."""
    rx, ry, rz = factors
    if mesh.nx % rx or (mesh.dim >= 2 and mesh.ny % ry) or (mesh.dim == 3 and mesh.nz % rz):
        raise ValueError(f"coarse factors {factors} must divide the mesh {mesh.shape}")
    xb = mesh.x_breaks[::rx]
    yb = mesh.y_breaks[::ry] if mesh.dim >= 2 else None
    zb = mesh.z_breaks[::rz] if mesh.dim == 3 else None
    cmesh = CartesianMesh.from_breaks(xb, yb, zb)

    fac = (rx, ry if mesh.dim >= 2 else 1, rz if mesh.dim == 3 else 1)
    vols = mesh.volumes()
    cxs = {}
    for key in ("D", "SigR", "NSF", "KSF", "Chi", "SRC", "SigS"):
        if key not in xs:
            continue
        cxs[key] = _block_mean(np.asarray(xs[key], dtype=np.float64), fac, vols)
    return cmesh, cxs


def coarse_init(
    fes: FESpace,
    ng: int,
    xs: Dict[str, np.ndarray],
    bcs: BCSpec,
    factors: Sequence[int],
    opts: SolveOptions,
    dtype,
    keff0: float = 1.0,
    marshak_d_factor: bool = False,
    coarse_a_mode: str = "exact",  # reference coarse solve uses the standard Schur
                                   # path (SolveKeff(false,{},false,false), :2568)
):
    """Solve the coarse RT0-P0 eigenproblem and return (keff_coarse, fine phi0).

    The returned flux fills the fine P_0 mode by piecewise-constant prolongation and
    leaves higher modes zero, ready to seed ``power_iteration`` on the fine space.
    """
    mesh = fes.mesh
    cmesh, cxs = coarsen_xs(mesh, xs, factors)
    cfes = make_fespace(cmesh, 0, 0)  # coarse is always RT0-P0 (NeutFEM.cpp:2453-2458)
    cctx = build_context(cfes, ng, cxs, bcs, a_mode=coarse_a_mode, dtype=dtype,
                         marshak_d_factor=marshak_d_factor)
    copts = dataclasses.replace(
        opts,
        tol_keff=opts.tol_keff * 10.0,
        tol_flux=opts.tol_flux * 10.0,
        max_outer=max(opts.max_outer // 2, 2),
        a_mode=coarse_a_mode,
        use_cmfd=False,
    )
    cphi0 = jnp.ones((ng, *cmesh.shape, 1), dtype=dtype)
    res = power_iteration(cfes, ng, copts, cctx, cphi0, keff0)

    rx, ry, rz = factors
    coarse_bar = res["phi"][..., 0]  # (ng, nzc, nyc, nxc)
    fine_bar = jnp.repeat(coarse_bar, rz if mesh.dim == 3 else 1, axis=1)
    fine_bar = jnp.repeat(fine_bar, ry if mesh.dim >= 2 else 1, axis=2)
    fine_bar = jnp.repeat(fine_bar, rx, axis=3)
    phi0 = jnp.zeros((ng, *mesh.shape, fes.P), dtype=dtype)
    phi0 = phi0.at[..., 0].set(fine_bar)
    return res["keff"], phi0
