"""Fine-mesh eigenvalue parity ladder for the 2D literature cores.

Runs each core over a mesh-refinement ladder and reports the reactivity
deviation vs the literature k_ref (pcm = 1e5 (1/k_ref - 1/k), the reference
drivers' convention, e.g. /root/reference/tests/biblis2d/biblis2d.py:39).

The reference publishes fine-mesh accuracy for IAEA-2D/BIBLIS/KOEBERG in its
README table (/root/reference/README.md:289-292) as its only accuracy evidence;
this tool reproduces that evidence for every core INCLUDING ZION (which
the reference never ran past coarse meshes), so the convergence trend toward
k_ref is a committed artifact rather than a coarse-mesh pin.

    python -m benchmarks.parity                 # all cores, default ladder
    python -m benchmarks.parity --cores zion2d --meshes 4,8,16,32
"""

from __future__ import annotations

import argparse
import json
import time

from .data import BENCHMARKS
from .runner import BenchmarkRun

__all__ = ["run_ladder", "main"]

DEFAULT_CORES = ("iaea2d", "biblis2d", "koeberg2d", "zion2d")
DEFAULT_MESHES = (4, 8, 16, 32)


def run_ladder(cores=DEFAULT_CORES, meshes=DEFAULT_MESHES, rt_order=0,
               tol=(1e-6, 1e-5, 1e-5, 300, 2000)):
    rows = []
    for name in cores:
        spec = BENCHMARKS[name]
        for n in meshes:
            run = BenchmarkRun(spec, mesh_n=n, rt_order=rt_order, verbose=False)
            # first solve includes the jit compile — report it separately; the
            # quotable wall is a SECOND solve from a cold flux
            t0 = time.time()
            run.solve(tol=tol)
            compile_plus_first = time.time() - t0
            run.solver.reset_flux()
            t0 = time.time()
            run.keff = run.solver.SolveKeff()
            wall = time.time() - t0
            outers = run.solver._last_outers
            rows.append({
                "core": name, "mesh": f"{n}x{n}",
                "n_cells": run.solver.GetNumElements(), "ng": spec.ng,
                "keff": round(run.keff, 7), "kref": spec.kref,
                "pcm": round(run.pcm, 2),
                "outer_iterations": outers,
                "solve_wall_s": round(wall, 3),
                "ms_per_outer": round(1e3 * wall / max(outers, 1), 3),
                "compile_plus_first_solve_s": round(compile_plus_first, 2),
            })
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cores", default=",".join(DEFAULT_CORES))
    p.add_argument("--meshes", default=",".join(map(str, DEFAULT_MESHES)))
    p.add_argument("--order", type=int, default=0, help="RT/P order")
    p.add_argument("--json", default=None, help="also write rows to this file")
    args = p.parse_args(argv)
    rows = run_ladder(cores=args.cores.split(","),
                      meshes=[int(m) for m in args.meshes.split(",")],
                      rt_order=args.order)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    # markdown summary table (paste into README)
    print("\n| core | mesh | cells | k_eff | k_ref | pcm |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['core']} | {r['mesh']} | {r['n_cells']} | {r['keff']:.6f} "
              f"| {r['kref']} | {r['pcm']:+.2f} |")
    return rows


if __name__ == "__main__":
    main()
