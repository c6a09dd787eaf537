"""Benchmark entry point (driver contract: print ONE JSON line).

Metric (BASELINE.json): IAEA-3D outer-iteration wall-time.  We run the IAEA-3D
literature benchmark (2 groups, 19 planes) at --mesh NxN via the reference-compatible
driver stack and report seconds per outer iteration of the accelerated power
iteration, measured on a second solve so one-time jit compilation is excluded
(the compiled executable is also persisted in the JAX compilation cache).

Default mesh 6x6 (x4 axial) = 987,696 cells: the finest BASELINE-acceptance mesh,
where the RT0-P0 discretization error vs the literature k_ref is sub-pcm (the
coarser meshes are discretization-limited: the reference's own math gives -19.5 pcm
at IAEA-2D 4x4 — adjudicated by the scipy transcription in tests/ref_replica.py,
see BASELINE.md "Adjudication").

vs_baseline: MEASURED CPU cost of the reference algorithm on a development host, from the
scipy transcription of the reference's exact-Schur CG power iteration
(tests/ref_replica.py; assembly per FEM.cpp:748-1008, solver per
solvers.cpp:577-636): 0.485 s/outer at 54,872 cells (IAEA-3D 2x2x2) with the
drivers' Schur tolerance 1e-4 (set_tol wires tol_flux into the Schur CG,
NeutFEM.cpp:334) = 8.84 us/cell/outer.  Extrapolating linearly in cells UNDERSTATES
the CPU cost at larger meshes (its CG iteration count grows ~h^-1), so
vs_baseline = (8.84e-6 * n_cells) / measured_seconds_per_outer is conservative.
(At the reference's hard-coded tol 1e-10 the same measurement is 48.7 us/cell/outer.)
Reproduce with: python tests/measure_cpu_baseline.py
"""

import json
import os
import subprocess
import time

# float32 solve path: the equilibrated Schur CG + normalized power iteration is
# float32-stable (measured vs float64: |dk| < 0.05 pcm on IAEA-2D 4x4 and
# KOEBERG 2x2; < 1 pcm at 92k-cell IAEA-2D 16x16 — tests/test_precision.py).
# Override with NEUTFEM_X64=1.
os.environ.setdefault("NEUTFEM_X64", "0")

import numpy as np

CPU_SECONDS_PER_CELL_PER_OUTER = 8.84e-6  # MEASURED (see docstring)


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them, plus the card's name
    and power limit from nvidia-smi.  Fails unless the backend is a GPU: a
    number from another backend is not a device measurement."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {d.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card.splitlines()[0]}


def main(mesh_n: int = 6, mesh_nz: int = 4) -> dict:
    from benchmarks.runner import BenchmarkRun
    from benchmarks.data import BENCHMARKS

    device = device_record()
    spec = BENCHMARKS["iaea3d"]
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False)
    n_cells = run.solver.GetNumElements()
    tol = (1e-5, 1e-4, 1e-4, 200, 1000)

    # solve 1: includes compile; then THREE timed solves from a cold flux and
    # report the MEDIAN
    t0 = time.time()
    run.solve(tol=tol)
    first = time.time() - t0
    walls = []
    for _ in range(3):
        run.solver.reset_flux()
        t0 = time.time()
        keff = run.solver.SolveKeff()
        walls.append(time.time() - t0)
    wall = float(np.median(walls))
    run.keff = keff

    outers = run.solver._last_outers

    pcm = 1e5 * (1.0 / spec.kref - 1.0 / keff)
    per_outer = wall / max(outers or 1, 1)
    inners = run.solver._last_inners
    # _last_inners already sums per-group CG iterations; each iteration touches one
    # group's n_phi DOFs, so no extra *ng factor (round-1 advisor finding).
    dofs_per_s = run.solver._fes.n_phi * inners / wall
    baseline_per_outer = CPU_SECONDS_PER_CELL_PER_OUTER * n_cells
    out = {
        "metric": "iaea3d_seconds_per_outer_iteration",
        "value": round(per_outer, 6),
        "unit": "s/outer",
        "vs_baseline": round(baseline_per_outer / per_outer, 3),
        "detail": {
            "keff": round(keff, 6),
            "kref": spec.kref,
            "pcm": round(pcm, 2),
            "n_cells": n_cells,
            "outer_iterations": outers,
            "inner_iterations": inners,
            "schur_cg_dofs_per_s": round(dofs_per_s, 1),
            "solve_wall_s": round(wall, 3),
            "solve_walls_3x_s": [round(w, 3) for w in walls],
            "compile_plus_first_solve_s": round(first, 3),
            "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}",
        },
        "device": device,
    }
    print(json.dumps(out))
    return out


def main_full() -> None:
    """--full: the headline row PLUS the higher-order, larger-scale, fine-2D and
    adjoint rows, one JSON line each, every one measured in this run."""
    from benchmarks.runner import BenchmarkRun
    from benchmarks.data import BENCHMARKS

    device = main()["device"]
    spec = BENCHMARKS["iaea3d"]
    configs = [
        ("iaea3d_rt1p1_seconds_per_outer_iteration", "4x4x2 RT1-P1", "iaea3d",
         dict(mesh_n=4, mesh_nz=2, rt_order=1), (1e-7, 1e-5, 1e-5, 120, 1000)),
        ("iaea3d_rt2p2_seconds_per_outer_iteration", "4x4x2 RT2-P2", "iaea3d",
         dict(mesh_n=4, mesh_nz=2, rt_order=2), (1e-7, 1e-5, 1e-5, 120, 1000)),
        ("iaea3d_2p6M_seconds_per_outer_iteration", "8x8x6", "iaea3d",
         dict(mesh_n=8, mesh_nz=6), (1e-5, 1e-4, 1e-4, 200, 1000)),
        ("iaea3d_3p5M_seconds_per_outer_iteration", "8x8x8", "iaea3d",
         dict(mesh_n=8, mesh_nz=8), (1e-5, 1e-4, 1e-4, 200, 1000)),
        ("koeberg2d_4group_seconds_per_outer_iteration", "32x32", "koeberg2d",
         dict(mesh_n=32), (1e-5, 1e-4, 1e-4, 200, 1000)),
        ("zion2d_seconds_per_outer_iteration", "48x48", "zion2d",
         dict(mesh_n=48), (1e-5, 1e-4, 1e-4, 200, 1000)),
    ]
    for metric, mesh_label, core, kwargs, tol in configs:
        cspec = BENCHMARKS[core]
        run = BenchmarkRun(cspec, verbose=False, **kwargs)
        run.solve(tol=tol)
        run.solver.reset_flux()
        t0 = time.time()
        keff = run.solver.SolveKeff()
        wall = time.time() - t0
        outers = run.solver._last_outers
        detail = {"keff": round(keff, 7),
                  "pcm": round(1e5 * (1.0 / cspec.kref - 1.0 / keff), 2),
                  "n_dofs": int(run.solver._fes.n_phi),
                  "n_groups": cspec.ng,
                  "outer_iterations": outers,
                  "inner_iterations": run.solver._last_inners,
                  "converged_not_capped": bool(outers < tol[3]),
                  "solve_wall_s": round(wall, 3), "mesh": mesh_label}
        print(json.dumps({"metric": metric, "value": round(wall / max(outers, 1), 6),
                          "unit": "s/outer", "detail": detail, "device": device}))

    # free-running adjoint at the headline scale: k-adjoint == k-direct
    run = BenchmarkRun(spec, mesh_n=6, mesh_nz=4, verbose=False)
    run.solve(tol=(1e-5, 1e-4, 1e-4, 200, 1000))
    k_direct = run.keff
    run.solver.SolveAdjoint(use_direct_keff=False)   # includes adjoint compile
    run.solver._phi_adj = None                        # cold adjoint flux, warm jit
    t0 = time.time()
    k_adj = run.solver.SolveAdjoint(use_direct_keff=False)
    wall = time.time() - t0
    outers = len(run.solver.get_iteration_history())
    print(json.dumps({
        "metric": "iaea3d_adjoint_seconds_per_outer_iteration",
        "value": round(wall / max(outers, 1), 6), "unit": "s/outer",
        "detail": {
            "keff_adjoint": round(k_adj, 7), "keff_direct": round(k_direct, 7),
            "adjoint_vs_direct_pcm": round(1e5 * abs(1.0 / k_direct - 1.0 / k_adj), 3),
            "n_cells": run.solver.GetNumElements(),
            "outer_iterations": outers,
            "solve_wall_s": round(wall, 3), "mesh": "6x6x4",
        },
        "device": device,
    }))


if __name__ == "__main__":
    import sys

    if "--full" in sys.argv:
        main_full()
    else:
        n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
        nz = int(sys.argv[2]) if len(sys.argv) > 2 else 4
        main(n, nz)
