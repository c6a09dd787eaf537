"""Generic driver for the literature benchmarks, built on the compat `neutfem` API.

Plays the role of the per-benchmark classes in the reference's tests/ (same workflow:
layout expansion -> optional quarter/half domain -> per-cell XS fill -> BuildMatrices ->
SolveKeff [-> SolveAdjoint] -> pcm vs k_ref -> assembly power factors), but as one
shared, data-driven implementation.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from neutfem import BCType, LinearSolverType, NeutFEM, VerbosityLevel
from neutfem_jax.mesh import boundary_attribute

from .data import BENCHMARKS, BenchmarkSpec, sigr_of

__all__ = ["BenchmarkRun", "run_benchmark", "main"]


def _expand_layout(rows, n):
    """Subdivide each layout cell into n x n mesh cells."""
    return np.array([[c for c in row for _ in range(n)] for row in rows
                     for _ in range(n)])


def _slice_domain(grid, domain):
    """Reference domain conventions (iaea2d.py:136-151): quarter/half slicing.

    Midpoints are taken from the y/x axes (the two LAST axes — for 3D grids the
    first axis is nz, which need not equal ny)."""
    hy = grid.shape[-2] // 2
    hx = grid.shape[-1] // 2
    m = {
        "quart_so": (slice(hy, None), slice(None, hx)),
        "quart_no": (slice(None, hy), slice(None, hx)),
        "quart_ne": (slice(None, hy), slice(hx, None)),
        "quart_se": (slice(hy, None), slice(hx, None)),
        "moitie_s": (slice(hy, None), slice(None, None)),
        "moitie_o": (slice(None, None), slice(None, hx)),
        "moitie_n": (slice(None, hy), slice(None, None)),
        "moitie_e": (slice(None, None), slice(hx, None)),
    }
    if domain in m:
        ys, xs = m[domain]
        return grid[..., ys, xs]
    return grid


class BenchmarkRun:
    """Holds the solver + results of one benchmark execution."""

    def __init__(self, spec: BenchmarkSpec, mesh_n: int = 2, mesh_nz: int = 1,
                 domain: str = "entier", verbose: bool = False,
                 rt_order: int = 0, p_order: Optional[int] = None):
        self.spec = spec
        self.mesh_n = mesh_n
        self.mesh_nz = mesh_nz
        self.domain = domain
        self.verbose = verbose
        self.rt_order = int(rt_order)
        self.p_order = int(p_order) if p_order is not None else self.rt_order
        self.keff: Optional[float] = None
        self.keff_adj: Optional[float] = None
        self.Fass: Optional[np.ndarray] = None
        self.solve_seconds: Optional[float] = None
        self.outer_iterations: Optional[int] = None
        self._build()

    # -- geometry + XS --------------------------------------------------------

    def _build(self):
        spec = self.spec
        n = self.mesh_n
        if spec.dim == 3:
            planes = [
                _expand_layout(p, n) for p in spec.layout3d for _ in range(self.mesh_nz)
            ]
            grid = _slice_domain(np.array(planes), self.domain)
            nz, ny, nx = grid.shape
            hz = spec.pitch_z / self.mesh_nz
            z_breaks = np.linspace(0.0, nz * hz, nz + 1)
        else:
            grid = _slice_domain(_expand_layout(spec.layout, n), self.domain)
            grid = grid[None]  # (1, ny, nx)
            nz, ny, nx = grid.shape
            z_breaks = np.array([0.0])
        self.grid = grid

        h = spec.pitch / n
        x_breaks = np.linspace(0.0, nx * h, nx + 1)
        y_breaks = np.linspace(0.0, ny * h, ny + 1)

        if self.rt_order == self.p_order:
            s = NeutFEM(self.rt_order, spec.ng, x_breaks, y_breaks, z_breaks)
        else:
            s = NeutFEM(self.rt_order, self.p_order, spec.ng, x_breaks, y_breaks,
                        z_breaks)
        s.set_verbosity(VerbosityLevel.NORMAL if self.verbose else VerbosityLevel.SILENT)
        s.set_linear_solver(LinearSolverType.BICGSTAB)

        # Cut planes as (axis, upper) pairs so the same logic serves 2D and 3D
        # (the reference drivers assign MIRROR to TOP/RIGHT for quart_so,
        # iaea2d.py:284-288 — but after their own row/column slicing the cut planes
        # are BOTTOM/RIGHT.  Harmless there: the reference's MIRROR is a silent
        # no-op, NeutFEM.cpp:2128-2131.  Wrong with a working MIRROR, so we set the
        # geometrically correct cut planes per quadrant.)
        cuts = {
            "entier": (),
            # rows slice start => cut at low y; cols end => high x
            "quart_so": ((1, False), (0, True)),
            "quart_no": ((1, True), (0, True)),
            "quart_ne": ((1, True), (0, False)),
            "quart_se": ((1, False), (0, False)),
            "moitie_s": ((1, False),),
            "moitie_n": ((1, True),),
            "moitie_o": ((0, True),),
            "moitie_e": ((0, False),),
        }
        if self.domain not in cuts:
            raise ValueError(f"unsupported domain {self.domain!r}")
        cut = set(cuts[self.domain])
        if self.domain.startswith("quart"):
            s.apply_quarter_rotational_symmetry(0, 1)
        for axis in range(spec.dim):
            for upper in (False, True):
                attr = boundary_attribute(spec.dim, axis, upper)
                kind = BCType.MIRROR if (axis, upper) in cut else BCType.DIRICHLET
                s.set_bc(attr, kind, 0.0)

        self._fill_xs(s)
        s.BuildMatrices()
        self.solver = s

    def _material_at(self, grid, k, i, j):
        spec = self.spec
        ch = grid[k, i, j]
        if ch != ".":
            return spec.materials[ch]
        if spec.baffle is not None:
            # ZION: empty cells within one baffle-thickness of fuel are steel baffle,
            # others are water (zion2d.py:265-303 nearest-assembly search).
            mat_b, thick, fuel_chars = spec.baffle
            cell = spec.pitch / self.mesh_n
            r = max(1, int(np.ceil(thick / cell)))
            nz, ny, nx = grid.shape
            for di in range(-r, r + 1):
                for dj in range(-r, r + 1):
                    ii, jj = i + di, j + dj
                    if 0 <= ii < ny and 0 <= jj < nx and grid[k, ii, jj] in fuel_chars:
                        return mat_b
        return spec.background

    def _fill_xs(self, s: NeutFEM):
        spec = self.spec
        ng = spec.ng
        grid = self.grid
        nz, ny, nx = grid.shape

        D = np.zeros((ng, nz, ny, nx))
        SigR = np.zeros_like(D)
        NSF = np.zeros_like(D)
        Chi = np.zeros_like(D)
        SigS = np.zeros((ng, ng, nz, ny, nx))

        cache = {}
        for k in range(nz):
            for i in range(ny):
                for j in range(nx):
                    mat = self._material_at(grid, k, i, j)
                    key = id(mat)
                    if key not in cache:
                        cache[key] = (np.array(mat["D"]), np.array(sigr_of(mat, ng)),
                                      np.array(mat["NSF"]), np.array(mat["CHI"]))
                    d, sr, nsf, chi = cache[key]
                    D[:, k, i, j] = d
                    SigR[:, k, i, j] = sr
                    NSF[:, k, i, j] = nsf
                    Chi[:, k, i, j] = chi
                    for (gt, gf), v in mat["S"].items():
                        SigS[gt, gf, k, i, j] = v

        def sq(a):
            return a[..., 0, :, :] if spec.dim == 2 else a

        s.get_D()[:] = sq(D)
        s.get_SigR()[:] = sq(SigR)
        s.get_NSF()[:] = sq(NSF)
        s.get_Chi()[:] = sq(Chi)
        s.get_SigS()[:] = sq(SigS)
        s.get_KSF()[:] = sq(NSF)  # power proxy

    # -- solve + metrics -------------------------------------------------------

    def solve(self, tol=(1e-5, 1e-4, 1e-4, 200, 1000), use_coarse_init=False,
              coarse_factors=(), adjoint=False, use_cmfd=False,
              use_diagonal_solver=False):
        s = self.solver
        s.set_tol(*tol)
        t0 = time.time()
        self.keff = s.SolveKeff(use_coarse_init=use_coarse_init,
                                coarse_factors=list(coarse_factors),
                                use_diagonal_solver=use_diagonal_solver,
                                use_cmfd=use_cmfd)
        self.solve_seconds = time.time() - t0
        if adjoint:
            self.keff_adj = s.SolveAdjoint()
        self._power_factors()
        return self.keff

    @property
    def pcm(self) -> float:
        """Reactivity deviation vs k_ref: 1e5 (1/k_ref - 1/k) (iaea2d.py:389)."""
        return 1e5 * (1.0 / self.spec.kref - 1.0 / self.keff)

    def _power_factors(self):
        """Assembly power factors normalized to the number of fuel assemblies
        (iaea2d.py:406-420).  Only meaningful for the 2D cores on full domain."""
        if self.spec.dim != 2 or self.domain != "entier":
            return
        s = self.solver
        flux = s.get_flux()     # (ng, ny, nx)
        nsf = s.get_NSF()
        pvol = (nsf * flux).sum(axis=0)
        n = self.mesh_n
        na = pvol.shape[0] // n
        fass = pvol.reshape(na, n, na, n).sum(axis=(1, 3))
        total = fass.sum()
        if self.spec.n_fuel_assemblies and total > 0:
            fass = self.spec.n_fuel_assemblies * fass / total
        self.Fass = fass

    def power_deviation(self, reference_map: np.ndarray) -> np.ndarray:
        """% deviation of assembly power factors vs a reference table (check_Ffaisc)."""
        return 100.0 * (reference_map - self.Fass) / reference_map

    # -- plotting (reference driver parity: iaea2d.py:82-130, 437-477) ----------

    def _heatmap(self, data, title, cbar_label=None, annot=None, path=None):
        """One heatmap panel (matplotlib, Agg-safe).  Saves a PNG when ``path``
        is given, else plt.show() like the reference's seaborn plots."""
        import matplotlib

        if path is not None:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(np.asarray(data, float), cmap="jet", interpolation="nearest")
        fig.colorbar(im, ax=ax, label=cbar_label)
        if annot is not None:
            ny, nx = np.shape(data)[:2]
            for i in range(ny):
                for j in range(nx):
                    ax.text(j, i, format(data[i][j], annot), ha="center",
                            va="center", fontsize=7, color="w")
        ax.set_title(title)
        fig.tight_layout()
        if path is not None:
            fig.savefig(path, dpi=110)
            plt.close(fig)
            return path
        plt.show()
        return None

    def _plane(self, a):
        """Mid-plane slice of a (possibly 3D) per-cell field."""
        return a[a.shape[0] // 2] if self.spec.dim == 3 and a.ndim == 3 else a

    def plot_geometry(self, path=None):
        """Geometry map: 0 = background, 1.. = material index (plot_geom,
        iaea2d.py:82-97)."""
        chars = sorted(self.spec.materials)
        lut = {c: i + 1 for i, c in enumerate(chars)}
        grid = self.grid[self.grid.shape[0] // 2]
        img = [[lut.get(c, 0) for c in row] for row in grid]
        return self._heatmap(img, f"Geometry - {self.spec.name} "
                             f"{self.mesh_n}x{self.mesh_n} - {self.domain}",
                             path=path)

    def plot_flux(self, group=0, adjoint=False, path=None):
        """Scalar-flux heatmap for one group (plot_flux, iaea2d.py:437-452)."""
        s = self.solver
        flux = s.get_flux_adj() if adjoint else s.get_flux()
        label = "adjoint" if adjoint else "direct"
        keff = self.keff_adj if adjoint else self.keff
        return self._heatmap(self._plane(np.asarray(flux[group])),
                             f"Flux group {group + 1} ({label}) - "
                             f"k-eff = {keff:.5f}",
                             cbar_label=f"flux g{group + 1} ({label})", path=path)

    def plot_power(self, path=None):
        """Per-cell fission power (plot_pvol, iaea2d.py:454-465)."""
        s = self.solver
        pvol = (np.asarray(s.get_NSF()) * np.asarray(s.get_flux())).sum(axis=0)
        return self._heatmap(self._plane(pvol),
                             f"Power distribution - k-eff = {self.keff:.5f}",
                             cbar_label="power", path=path)

    def plot_fass(self, path=None):
        """Annotated assembly power factors (plot_Fass, iaea2d.py:467-477)."""
        if self.Fass is None:
            return None
        return self._heatmap(self.Fass, f"Assembly power factors - "
                             f"k-eff = {self.keff:.5f}", annot=".4f", path=path)

    def plot_all(self, directory=".", stem=None):
        """Write every available heatmap as PNG; returns the paths written."""
        import os

        stem = stem or self.spec.name
        os.makedirs(directory, exist_ok=True)
        out = []
        for nm, fn in [("geom", self.plot_geometry), ("power", self.plot_power),
                       ("fass", self.plot_fass)]:
            p = fn(path=os.path.join(directory, f"{stem}_{nm}.png"))
            if p:
                out.append(p)
        for g in range(self.spec.ng):
            out.append(self.plot_flux(
                group=g, path=os.path.join(directory, f"{stem}_flux_g{g + 1}.png")))
        if self.keff_adj is not None:
            for g in range(self.spec.ng):
                out.append(self.plot_flux(
                    group=g, adjoint=True,
                    path=os.path.join(directory, f"{stem}_adjflux_g{g + 1}.png")))
        return out


def run_benchmark(name: str, mesh_n: int = 2, mesh_nz: int = 1, domain: str = "entier",
                  adjoint: bool = False, use_coarse_init: bool = False,
                  coarse_factors=(), tol=(1e-5, 1e-4, 1e-4, 200, 1000),
                  verbose: bool = False, use_cmfd: bool = False,
                  use_diagonal_solver: bool = False, rt_order: int = 0,
                  p_order: Optional[int] = None) -> BenchmarkRun:
    run = BenchmarkRun(BENCHMARKS[name], mesh_n=mesh_n, mesh_nz=mesh_nz,
                       domain=domain, verbose=verbose, rt_order=rt_order,
                       p_order=p_order)
    run.solve(tol=tol, adjoint=adjoint, use_coarse_init=use_coarse_init,
              coarse_factors=coarse_factors, use_cmfd=use_cmfd,
              use_diagonal_solver=use_diagonal_solver)
    return run


def main(name: str, argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=f"{name} benchmark (NeutFEM on JAX)")
    p.add_argument("--mesh", default="2x2", help="NxN subdivision per assembly")
    p.add_argument("--mesh-z", type=int, default=1, help="axial subdivisions per plane (3D)")
    p.add_argument("--domain", default="entier")
    p.add_argument("--order", type=int, default=None, help="RT_k-P_k order")
    p.add_argument("--rt-order", type=int, default=0)
    p.add_argument("--p-order", type=int, default=None)
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--coarse", action="store_true", help="use coarse-grid init")
    p.add_argument("--cmfd", action="store_true")
    p.add_argument("--diag", action="store_true", help="reference diagonal-Schur mode")
    p.add_argument("--vtk", default=None, help="export VTK to this basename")
    p.add_argument("--plot", action="store_true",
                   help="write geometry/flux/power/Fass heatmap PNGs")
    p.add_argument("--plot-dir", default=".", help="directory for --plot PNGs")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    n = int(str(args.mesh).split("x")[0])
    spec = BENCHMARKS[name]
    rt = args.order if args.order is not None else args.rt_order
    po = args.order if args.order is not None else args.p_order
    run = BenchmarkRun(spec, mesh_n=n, mesh_nz=args.mesh_z, domain=args.domain,
                       verbose=args.verbose, rt_order=rt, p_order=po)
    cf = ()
    if args.coarse:
        from neutfem_jax.coarse import default_coarse_factors

        cf = list(default_coarse_factors(run.solver._mesh))
    t0 = time.time()
    run.solve(adjoint=args.adjoint, use_coarse_init=args.coarse,
              coarse_factors=cf, use_cmfd=args.cmfd,
              use_diagonal_solver=args.diag)
    wall = time.time() - t0

    print(f"{name}: k-eff = {run.keff:.6f}  (k_ref = {spec.kref})  "
          f"pcm = {run.pcm:+.2f}  wall = {wall:.2f}s")
    if run.keff_adj is not None:
        print(f"  adjoint k-eff = {run.keff_adj:.6f}  |k-k_adj| = "
              f"{abs(run.keff - run.keff_adj):.2e}")
    if run.Fass is not None:
        print(f"  assembly power factors: max = {np.nanmax(run.Fass):.4f}")
    if args.vtk:
        run.solver.ExportVTK(args.vtk, export_flux=True, export_current=True,
                             export_xs=True, export_adjoint=args.adjoint)
        print(f"  VTK written to {args.vtk}.vtk")
    if args.plot:
        for path in run.plot_all(directory=args.plot_dir):
            print(f"  plot written to {path}")
    return run
