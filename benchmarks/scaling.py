"""Scaling ladder: IAEA-3D per-outer wall-time vs cell count.

Usage: python -m benchmarks.scaling [--x64] [--meshes 2x2,4x4x3,6x6x4,8x8x6,8x8x8]

Each row re-solves from a cold flux after a warm-up solve so jit compilation is
excluded (compilations are also persisted in the JAX compilation cache).
VERDICT round-1 item #3 acceptance: per-outer time scaling <= ~1.5x per
cell-count doubling up to 3.5M cells.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# NOTE: `python -m benchmarks.scaling` imports the `benchmarks` package (and so
# neutfem_jax.config) BEFORE this module's code runs, so env vars set here are too
# late — the dtype is flipped at runtime via config.set_x64() in main() instead.
if "--cpu" in sys.argv:
    # CPU cross-check platform: select it through jax.config before the backend
    # is initialized
    import jax

    jax.config.update("jax_platforms", "cpu")


def run_one(mesh_n: int, mesh_nz: int):
    from benchmarks.runner import BenchmarkRun
    from benchmarks.data import BENCHMARKS

    spec = BENCHMARKS["iaea3d"]
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False)
    n_cells = run.solver.GetNumElements()
    run.solve(tol=(1e-5, 1e-4, 1e-4, 200, 1000))
    run.solver.reset_flux()
    t0 = time.time()
    keff = run.solver.SolveKeff()
    wall = time.time() - t0
    outers = run.solver._last_outers
    pcm = 1e5 * (1.0 / spec.kref - 1.0 / keff)
    return {
        "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}",
        "n_cells": n_cells,
        "keff": round(float(keff), 7),
        "pcm": round(float(pcm), 2),
        "outers": int(outers),
        "inners": int(run.solver._last_inners),
        "wall_s": round(wall, 3),
        "s_per_outer": round(wall / max(outers, 1), 5),
        "device": _device(),
    }


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on CPU (native float64 with --x64)")
    ap.add_argument(
        "--meshes", default="2x2x2,4x4x3,6x6x4,8x8x6,8x8x8",
        help="comma list of NxN[xNZ] IAEA-3D mesh configs",
    )
    args = ap.parse_args()
    from neutfem_jax import config

    config.set_x64(args.x64)

    prev = None
    for tok in args.meshes.split(","):
        parts = [int(p) for p in tok.split("x")]
        if len(parts) >= 2 and parts[1] != parts[0]:
            raise SystemExit(
                f"--meshes token {tok!r}: the horizontal subdivision must be square "
                f"(NxNxNZ, got {parts[0]}x{parts[1]} in-plane)"
            )
        n, nz = parts[0], (parts[2] if len(parts) > 2 else parts[0])
        row = run_one(n, nz)
        if prev is not None and row["s_per_outer"] > 0 and prev["s_per_outer"] > 0:
            import math
            ratio_cells = row["n_cells"] / prev["n_cells"]
            ratio_t = row["s_per_outer"] / prev["s_per_outer"]
            # per-doubling growth factor of the per-outer time
            row["per_doubling"] = round(ratio_t ** (1.0 / math.log2(ratio_cells)), 3)
        print(json.dumps(row), flush=True)
        prev = row


if __name__ == "__main__":
    main()
