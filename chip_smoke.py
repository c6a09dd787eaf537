"""On-card smoke test: the IAEA-3D k-eff solve and its kernels on one GPU.

    python chip_smoke.py            # phases 0-5 on one card
    python chip_smoke.py --multi    # the z-sharded solve on four cards, vs one card

Every phase prints one JSON line with its wall and compile seconds and the device;
any failed check raises, so the script exits non-zero and prints no final line.
The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Phases:
  0  device: platform, device kind, JAX version, card name and power limit
     (nvidia-smi, the only child process), compile-cache directory;
  1  kernels at IAEA-3D 6x6x4 face widths: the Thomas kernel against the
     associative-scan solve and the fused RT0 direction against the unfused XLA
     chain, per direction, with max relative error, tolerance and ms per call;
  2  headline: IAEA-3D 6x6x4 RT0-P0 in float32 through benchmarks.runner
     (k, pcm, outers, inners, ms/outer, memory), the same solve in float64, and
     ms/outer, ms/inner, outers and inners with and without the kernels
     (NEUTFEM_PALLAS=0), alternating;
  3  IAEA-3D 4x4x2 RT1-P1 (condensed chain, fp8 block-Jacobi) must converge,
     with the same kernels-vs-XLA comparison;
  4  KOEBERG-2D 32x32, 4 groups with upscatter (two-grid correction), with the
     same comparison on its 544-line solves;
  5  free-running adjoint at IAEA-3D 6x6x4: |k - k_adj| <= tol_keff.

Runs in one process; every result is float32 unless a phase says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

if __name__ == "__main__":
    # float32 working precision, set before neutfem_jax.config is imported
    # (importing this module, as the tests do, leaves the setting alone)
    os.environ.setdefault("NEUTFEM_X64", "0")

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.data import BENCHMARKS  # noqa: E402
from benchmarks.runner import BenchmarkRun  # noqa: E402
from neutfem_jax import config  # noqa: E402

#: IAEA-3D at mesh 6x6x4: 987,696 cells
IAEA_MESH = (6, 4)
#: the f32 and f64 solves of one mesh must agree this closely (pcm); the CPU
#: suite pins the same agreement at < 0.05 pcm (tests/test_precision.py)
F32_F64_PCM = 0.1
#: IAEA-3D 6x6x4 RT0 against the literature k_ref (pcm)
IAEA_PCM = 2.0
#: KOEBERG-2D against k_ref: the bound tests/test_benchmarks.py pins from 8x8 up
KOEBERG_PCM = 10.0
#: unit roundoff of float32
U32 = 2.0 ** -24


def device_record() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def emit(phase: str, **fields) -> dict:
    line = {"phase": phase, **fields, "device": device_record()}
    print(json.dumps(line), flush=True)
    return line


def card_name_and_power() -> str:
    """``name, power.limit`` of the card from nvidia-smi (a child that does not
    import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu() -> None:
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {platform!r}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_calls(fn, *args, reps: int = 30):
    """(first-call seconds, median steady ms per call): each call ends in
    block_until_ready; the first includes compilation."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, first, 1e3 * float(np.median(ts))


def time_in_loop(fn, x, *args, iters: int = 100) -> float:
    """Device ms per call of ``x -> fn(x, *args)`` chained ``iters`` times
    inside one jitted fori_loop (each call consumes the previous output, so
    none is elided): launch cost without the host round trip per call."""
    loop = jax.jit(lambda x0, *a: jax.lax.fori_loop(
        0, iters, lambda i, x: fn(x, *a), x0))
    jax.block_until_ready(loop(x, *args))
    t0 = time.perf_counter()
    jax.block_until_ready(loop(x, *args))
    return 1e3 * (time.perf_counter() - t0) / iters


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def thomas_tolerance(n: int, kappa: float) -> float:
    """Max relative error allowed between two f32 solves of a diagonally
    dominant SPD tridiagonal system of length n: both are backward stable, so
    each is within ~2 n u kappa of the exact solution (u = 2^-24, kappa the
    condition number); the difference gets twice that."""
    return 4.0 * n * U32 * kappa


# ---------------------------------------------------------------------------
# phase 1: kernels at real widths
# ---------------------------------------------------------------------------

def phase_kernels(shape=(76, 114, 114), interpret: bool = False, reps: int = 30,
                  seed: int = 0) -> list:
    """Thomas kernel vs ``_scan_solve`` and fused RT0 direction vs the unfused
    XLA chain, for each direction of a (nz, ny, nx) cell grid."""
    from neutfem_jax.fespace import make_fespace
    from neutfem_jax.mesh import CartesianMesh
    from neutfem_jax.ops.apply import apply_B_dir, apply_BT_dir, solve_A_dir
    from neutfem_jax.ops.pallas_fused import fused_schur_dir
    from neutfem_jax.ops.pallas_tridiag import thomas_solve
    from neutfem_jax.ops.tridiag import _scan_solve, tridiag_factor

    nz, ny, nx = shape
    dt = jnp.float32
    rng = np.random.default_rng(seed)
    mesh = CartesianMesh.from_breaks(*(np.linspace(0.0, 1.0, k + 1) for k in (nx, ny, nz)))
    fes = make_fespace(mesh, 0, 0)
    # diag in [2, 3], |off| <= 0.5: Gershgorin puts the spectrum in [1, 4]
    kappa = 4.0
    v = jnp.asarray(rng.normal(size=(1, nz, ny, nx)), dt)
    acc = jnp.asarray(rng.normal(size=(1, nz, ny, nx)), dt)
    lines = []
    for di in sorted(fes.dirs, key=lambda d: d.axis):  # z, y, x
        ax = di.axis
        name = "zyx"[ax]
        fshape = [nz, ny, nx]
        fshape[ax] += 1
        oshape = list(fshape)
        oshape[ax] -= 1
        diag = jnp.asarray(rng.uniform(2.0, 3.0, fshape), dt)
        off = jnp.asarray(rng.uniform(-0.5, 0.5, oshape), dt)
        dinv, l = tridiag_factor(diag, off, axis=ax)
        rhs = jnp.asarray(rng.normal(size=(1, *fshape)), dt)
        dinv1, l1 = dinv[None], l[None]
        n = fshape[ax]
        tol = thomas_tolerance(n + 1, kappa)

        scan = jax.jit(lambda r, d, lo, a=ax + 1: _scan_solve(r, d, lo, a))
        kern = jax.jit(lambda r, d, lo, a=ax + 1: thomas_solve(r, d, lo, a,
                                                              interpret=interpret))
        want, _, xla_ms = time_calls(scan, rhs, dinv1, l1, reps=reps)
        got, first, k_ms = time_calls(kern, rhs, dinv1, l1, reps=reps)
        err = rel_err(got, want)
        lines.append(emit("kernels", kernel="thomas_solve", direction=name,
                          shape=list(rhs.shape), max_rel_err=err, tol=tol,
                          kernel_ms_per_call=k_ms, xla_ms_per_call=xla_ms,
                          kernel_ms_per_call_in_loop=time_in_loop(kern, rhs, dinv1, l1),
                          xla_ms_per_call_in_loop=time_in_loop(scan, rhs, dinv1, l1),
                          compile_s=max(first - k_ms / 1e3, 0.0),
                          reference="_scan_solve"))
        check(err <= tol, f"thomas_solve {name}: rel err {err} > {tol}")

        mask = jnp.ones(fshape, dt)
        alpha = jnp.ones((nz, ny, nx), dt)

        def unfused(acc, v, dinv, l, di=di):
            rF, rW = apply_BT_dir(fes, di, v)
            F, W = solve_A_dir(fes, di, dinv, l, mask, alpha, rF, rW, "exact",
                               kernel=False)
            return acc + apply_B_dir(fes, di, F, W)

        bx0, bx1 = float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0])
        si = 1.0 / float(di.m_t[0])
        fused = jax.jit(lambda acc, v, d, lo, a=ax: fused_schur_dir(
            acc, v, d[None], lo[None], a - 3, bx0, bx1, si, interpret=interpret))
        unfused = jax.jit(unfused)
        want, _, xla_ms = time_calls(unfused, acc, v, dinv, l, reps=reps)
        got, first, k_ms = time_calls(fused, acc, v, dinv, l, reps=reps)
        err = rel_err(got, want)
        # the face rhs and divergence add O(1) roundings per entry on top of
        # the solve
        tol = thomas_tolerance(n + 3, kappa)
        # chained through v (acc fixed): S-like maps keep the values bounded
        loop_k = time_in_loop(lambda x, a, d, lo: fused(a, x, d, lo), v, acc, dinv, l)
        loop_x = time_in_loop(lambda x, a, d, lo: unfused(a, x, d, lo), v, acc, dinv, l)
        lines.append(emit("kernels", kernel="fused_schur_dir", direction=name,
                          shape=list(v.shape), max_rel_err=err, tol=tol,
                          kernel_ms_per_call=k_ms, xla_ms_per_call=xla_ms,
                          kernel_ms_per_call_in_loop=loop_k,
                          xla_ms_per_call_in_loop=loop_x,
                          compile_s=max(first - k_ms / 1e3, 0.0),
                          reference="unfused XLA chain (apply_BT, scan solve, apply_B)"))
        check(err <= tol, f"fused_schur_dir {name}: rel err {err} > {tol}")
    return lines


# ---------------------------------------------------------------------------
# phases 2-5: solves through the compat driver stack
# ---------------------------------------------------------------------------

HEADLINE_TOL = (1e-5, 1e-4, 1e-4, 200, 1000)
#: the f32/f64 comparison converges both solves well below F32_F64_PCM
#: (tol_keff = 1e-7 is 0.01 pcm), as tests/test_precision.py does
PRECISION_TOL = (1e-7, 1e-6, 1e-6, 400, 2000)


def _solve_record(run: BenchmarkRun, tol) -> dict:
    """First solve (compile + solve) and one warm solve from a cold flux."""
    s = run.solver
    t0 = time.perf_counter()
    run.solve(tol=tol)
    first = time.perf_counter() - t0
    s.reset_flux()
    t0 = time.perf_counter()
    keff = s.SolveKeff()
    wall = time.perf_counter() - t0
    run.keff = keff
    outers, inners = s._last_outers, s._last_inners
    return {"keff": keff, "kref": run.spec.kref, "pcm": run.pcm,
            "outers": outers, "inners": inners, "solve_s": wall,
            "ms_per_outer": 1e3 * wall / max(outers, 1),
            "compile_s": max(first - wall, 0.0), "max_outer": tol[3]}


def _memory(run: BenchmarkRun) -> dict:
    s = run.solver
    fn = s._solver_fn(s._opts("exact"), False, False)
    compiled = fn.lower(s._ctx("exact"), s._flat_phi(), 1.0).compile()
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k) for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                       "temp_size_in_bytes", "generated_code_size_in_bytes")
           if ma is not None and hasattr(ma, k)}
    stats = jax.devices()[0].memory_stats() or {}
    mem["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return mem


def _ab_kernels(run: BenchmarkRun, reps: int = 2) -> dict:
    """The same solve with the kernels ("kernels") and with NEUTFEM_PALLAS=0
    ("xla"), alternating, in this process: per variant and rep the ms/outer,
    ms/inner, outers and inners.  Each variant is traced under its own setting
    (the choice is made at trace time).  ``ab_counts_agree`` says whether every
    run took the same outers and inners, i.e. whether ms/outer compares the
    cost of equal work."""
    s = run.solver
    ctx, phi0 = s._ctx("exact"), s._flat_phi()
    opts = s._opts("exact")
    prev = os.environ.get("NEUTFEM_PALLAS")
    fns = {}
    try:
        for label, val in (("kernels", "1"), ("xla", "0")):
            os.environ["NEUTFEM_PALLAS"] = val
            s._fn_cache.clear()
            fns[label] = s._solver_fn(opts, False, False)
            jax.block_until_ready(fns[label](ctx, phi0, 1.0))  # trace + compile
    finally:
        if prev is None:
            os.environ.pop("NEUTFEM_PALLAS", None)
        else:
            os.environ["NEUTFEM_PALLAS"] = prev
        s._fn_cache.clear()
    out = {f"{m}_{label}": [] for label in fns
           for m in ("ms_per_outer", "ms_per_inner", "outers", "inners")}
    for _ in range(reps):
        for label, fn in fns.items():
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(ctx, phi0, 1.0))
            wall = time.perf_counter() - t0
            outers, inners = int(res["outer_iterations"]), int(res["inner_iterations"])
            out[f"ms_per_outer_{label}"].append(1e3 * wall / max(outers, 1))
            out[f"ms_per_inner_{label}"].append(1e3 * wall / max(inners, 1))
            out[f"outers_{label}"].append(outers)
            out[f"inners_{label}"].append(inners)
    counts = {(o, i) for label in fns
              for o, i in zip(out[f"outers_{label}"], out[f"inners_{label}"])}
    out["ab_counts_agree"] = len(counts) == 1
    return out


def phase_headline(mesh=IAEA_MESH, pcm_limit=IAEA_PCM, ab_reps: int = 2) -> dict:
    spec = BENCHMARKS["iaea3d"]
    run = BenchmarkRun(spec, mesh_n=mesh[0], mesh_nz=mesh[1])
    rec = _solve_record(run, HEADLINE_TOL)
    rec["n_cells"] = run.solver.GetNumElements()
    rec["memory"] = _memory(run)
    rec.update(_ab_kernels(run, reps=ab_reps))
    line = emit("headline_f32", mesh=f"{mesh[0]}x{mesh[0]}x{mesh[1]}", rt="RT0-P0",
                dtype=jnp.dtype(config.real_dtype).name, **rec)
    check(rec["outers"] < HEADLINE_TOL[3], "headline f32 hit the outer cap")
    if pcm_limit is not None:
        check(abs(rec["pcm"]) <= pcm_limit, f"pcm {rec['pcm']} outside +-{pcm_limit}")

    run.solver.set_tol(*PRECISION_TOL)
    run.solver.reset_flux()
    k32 = run.solver.SolveKeff()
    x64 = config.x64_enabled()
    config.set_x64(True)
    try:
        run64 = BenchmarkRun(spec, mesh_n=mesh[0], mesh_nz=mesh[1])
        rec64 = _solve_record(run64, PRECISION_TOL)
    finally:
        config.set_x64(x64)
    d_pcm = 1e5 * abs(1.0 / k32 - 1.0 / rec64["keff"])
    emit("headline_f64", mesh=f"{mesh[0]}x{mesh[0]}x{mesh[1]}", rt="RT0-P0",
         dtype="float64", keff_f32_same_tol=k32, f32_f64_pcm=d_pcm,
         limit_pcm=F32_F64_PCM, **rec64)
    check(d_pcm <= F32_F64_PCM, f"f32 vs f64 differ by {d_pcm} pcm")
    return line


def phase_rt1(mesh=(4, 2), ab_reps: int = 2) -> dict:
    run = BenchmarkRun(BENCHMARKS["iaea3d"], mesh_n=mesh[0], mesh_nz=mesh[1],
                       rt_order=1)
    tol = (1e-7, 1e-5, 1e-5, 120, 1000)
    rec = _solve_record(run, tol)
    rec.update(_ab_kernels(run, reps=ab_reps))
    line = emit("rt1p1", mesh=f"{mesh[0]}x{mesh[0]}x{mesh[1]}", rt="RT1-P1",
                n_phi=run.solver._fes.n_phi, **rec)
    check(rec["outers"] < tol[3], "RT1-P1 hit the outer cap")
    return line


def phase_koeberg(mesh_n: int = 32, pcm_limit=KOEBERG_PCM, ab_reps: int = 2) -> dict:
    run = BenchmarkRun(BENCHMARKS["koeberg2d"], mesh_n=mesh_n)
    rec = _solve_record(run, HEADLINE_TOL)
    rec.update(_ab_kernels(run, reps=ab_reps))
    line = emit("koeberg2d", mesh=f"{mesh_n}x{mesh_n}", groups=4,
                twogrid="tg" in run.solver._ctx("exact"), limit_pcm=pcm_limit, **rec)
    check(rec["outers"] < HEADLINE_TOL[3], "KOEBERG hit the outer cap")
    if pcm_limit is not None:
        check(abs(rec["pcm"]) <= pcm_limit, f"KOEBERG pcm {rec['pcm']}")
    return line


#: the adjoint check converges both solves' fluxes to 1e-6, so each k is far
#: inside tol_keff of the eigenvalue and |k - k_adj| <= tol_keff is a real test
ADJOINT_TOL = (1e-5, 1e-6, 1e-6, 400, 2000)


def phase_adjoint(mesh=IAEA_MESH) -> dict:
    run = BenchmarkRun(BENCHMARKS["iaea3d"], mesh_n=mesh[0], mesh_nz=mesh[1])
    s = run.solver
    s.set_tol(*ADJOINT_TOL)
    k = s.SolveKeff()
    t0 = time.perf_counter()
    k_adj = s.SolveAdjoint(use_direct_keff=False)
    first = time.perf_counter() - t0
    line = emit("adjoint", mesh=f"{mesh[0]}x{mesh[0]}x{mesh[1]}", keff=k,
                keff_adj=k_adj, abs_diff=abs(k - k_adj), tol_keff=ADJOINT_TOL[0],
                tol_flux=ADJOINT_TOL[1], wall_s=first)
    check(abs(k - k_adj) <= ADJOINT_TOL[0], f"|k - k_adj| = {abs(k - k_adj)}")
    return line


# ---------------------------------------------------------------------------
# --multi: the z-sharded solve over four devices
# ---------------------------------------------------------------------------

def phase_multi(mesh=IAEA_MESH, n_devices: int = 4) -> dict:
    from neutfem_jax.parallel import (
        device_mesh,
        shard_context,
        shard_state,
        sharded_power_iteration,
    )
    from neutfem_jax.power import power_iteration

    check(len(jax.devices()) >= n_devices,
          f"--multi needs {n_devices} devices, JAX found {len(jax.devices())}")
    run = BenchmarkRun(BENCHMARKS["iaea3d"], mesh_n=mesh[0], mesh_nz=mesh[1])
    s = run.solver
    s.set_tol(*HEADLINE_TOL)
    fes, ng = s._fes, s._ng
    ctx, opts, phi0 = s._ctx("exact"), s._opts("exact"), s._flat_phi()
    nz = fes.mesh.shape[0]
    check(nz % n_devices == 0, f"nz = {nz} does not divide over {n_devices}")

    one = jax.jit(lambda c, p, k: power_iteration(fes, ng, opts, c, p, k))
    res1, first1, _ = time_calls(one, ctx, phi0, 1.0, reps=1)
    t0 = time.perf_counter()
    res1 = jax.block_until_ready(one(ctx, phi0, 1.0))
    wall1 = time.perf_counter() - t0

    dmesh = device_mesh(n_devices)
    ctx_sh = shard_context(ctx, dmesh, fes, grid_axis=0)
    phi_sh = shard_state(phi0, dmesh, grid_axis=0)
    run_sh, _ = sharded_power_iteration(fes, ng, opts, dmesh, grid_axis=0)
    t0 = time.perf_counter()
    res = jax.block_until_ready(run_sh(ctx_sh, phi_sh, 1.0))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(run_sh(ctx_sh, phi_sh, 1.0))
    wall = time.perf_counter() - t0

    k1, k4 = float(res1["keff"]), float(res["keff"])
    n_shards = len(res["phi"].devices())
    outers1, outers4 = int(res1["outer_iterations"]), int(res["outer_iterations"])
    line = emit("multi_z", mesh=f"{mesh[0]}x{mesh[0]}x{mesh[1]}", cut="z",
                n_devices=n_devices, keff_sharded=k4, keff_one_card=k1,
                diff_pcm=1e5 * abs(1.0 / k1 - 1.0 / k4), tol_keff=HEADLINE_TOL[0],
                flux_devices=n_shards, outers_sharded=outers4, outers_one_card=outers1,
                ms_per_outer_sharded=1e3 * wall / max(outers4, 1),
                ms_per_outer_one_card=1e3 * wall1 / max(outers1, 1),
                compile_s_sharded=max(first - wall, 0.0),
                compile_s_one_card=max(first1 - wall1, 0.0))
    check(abs(k1 - k4) <= HEADLINE_TOL[0], f"sharded k {k4} vs one card {k1}")
    check(n_shards == n_devices, f"flux spans {n_shards} devices, not {n_devices}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the z-sharded solve on four cards")
    args = ap.parse_args(argv)

    require_gpu()
    card = card_name_and_power()
    print(f"nvidia-smi: {card}", flush=True)
    emit("device", jax=jax.__version__, card=card,
         compile_cache_dir=config.compile_cache_dir(), x64=config.x64_enabled())
    if args.multi:
        phase_multi()
    else:
        phase_kernels()
        phase_headline()
        phase_rt1()
        phase_koeberg()
        phase_adjoint()
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
