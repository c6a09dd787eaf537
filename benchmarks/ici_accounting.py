"""Collective-traffic accounting from the compiled sharded HLO.

Compiles the FULL sharded power iteration (parallel.sharded_power_iteration)
for IAEA-3D meshes over a virtual CPU device mesh, parses the SPMD-partitioned
optimized HLO, and counts every collective byte by loop depth:

  depth 0  once per solve          (setup / final norms)
  depth 1  once per OUTER iteration (fission psum, flux norm, halo of the
                                     face-rhs build, CMFD off)
  depth 2  once per inner CG iteration PER GROUP (Schur-matvec halo exchange,
                                     cut-axis partitioned-solve gathers, CG
                                     dot-product all-reduces)

The virtual CPU mesh is a faithful proxy for the per-device collective SHAPES:
GSPMD partitioning is platform-independent, and every collective's output shape
in the partitioned module is already the per-device buffer.  Which A-solve
kernel runs per shard does not change the inventory: shard-local solves have no
collectives inside.  Bytes only; collective time is measured on the cards.

Per-inner bytes are reported per CG-body execution; the module contains one
structurally identical CG while per group, so module-level depth-2 sums are
divided by ng.  With ``--inners-per-outer`` (a measured count) the tool also
reports bytes per outer iteration.

    python -m benchmarks.ici_accounting                       # 4 devices
    python -m benchmarks.ici_accounting --scales 3.5M --inners-per-outer 39 --json out.json
"""

from __future__ import annotations

import argparse
import json
import math
import re
from typing import Dict, List, Optional

__all__ = ["collective_inventory", "accounting_for", "main"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%[\w.\-]+\s*=\s*(?P<type>\(.*?\)|\S+)\s+"
    r"(?P<op>collective-permute|all-reduce|all-gather|reduce-scatter|"
    r"all-to-all)(?P<start>-start)?\(")
_SHAPE_RE = re.compile(r"(?P<dt>[a-z0-9]+)\[(?P<dims>[\d,]*)\]")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


def _shape_bytes(type_str: str) -> int:
    """Bytes of the FIRST array shape in an HLO type (tuple types: the send
    buffer of an async start op; counting one side avoids double counting)."""
    m = _SHAPE_RE.search(type_str)
    if not m:
        return 0
    dt = _DTYPE_BYTES.get(m.group("dt"), 4)
    dims = [int(d) for d in m.group("dims").split(",") if d]
    return dt * int(math.prod(dims)) if dims else dt


def collective_inventory(hlo_text: str) -> List[Dict]:
    """[{op, bytes, depth, op_name}] for every collective instruction.

    depth = number of ``while/body`` scopes in the op_name metadata path
    (0 = per solve, 1 = per outer iteration, 2 = per inner CG iteration).
    ``-done`` halves of async pairs carry no '=' collective opcode of their
    own shape here because only ``-start`` matches the opcode regex.
    """
    out = []
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.match(line)
        if not m:
            continue
        nm = _OPNAME_RE.search(line)
        op_name = nm.group(1) if nm else ""
        out.append({
            "op": m.group("op"),
            "bytes": _shape_bytes(m.group("type")),
            "depth": op_name.count("while/body"),
            "op_name": op_name,
        })
    return out


def summarize(inv: List[Dict]) -> Dict:
    """{depth: {op: {count, bytes}}} + totals per depth."""
    by: Dict[int, Dict] = {}
    for c in inv:
        d = by.setdefault(c["depth"], {"bytes": 0, "count": 0, "ops": {}})
        d["bytes"] += c["bytes"]
        d["count"] += 1
        o = d["ops"].setdefault(c["op"], {"count": 0, "bytes": 0})
        o["count"] += 1
        o["bytes"] += c["bytes"]
    return {str(k): v for k, v in sorted(by.items())}


def accounting_for(summary: Dict, ng: int,
                   inners_per_outer: Optional[float] = None) -> Dict:
    """Per-inner and (given a measured inners/outer count) per-outer collective
    bytes and all-reduce counts from the depth-binned summary."""
    d1 = summary.get("1", {"bytes": 0, "count": 0, "ops": {}})
    d2 = summary.get("2", {"bytes": 0, "count": 0, "ops": {}})
    # depth-2 sums span the ng structurally identical per-group CG loops
    per_inner_bytes = d2["bytes"] / max(ng, 1)
    per_inner_ar = d2["ops"].get("all-reduce", {"count": 0})["count"] / max(ng, 1)
    out = {
        "per_outer_fixed_bytes": int(d1["bytes"]),
        "per_inner_bytes": int(per_inner_bytes),
        "per_inner_allreduces": round(per_inner_ar, 2),
    }
    if inners_per_outer is not None:
        bytes_per_outer = d1["bytes"] + per_inner_bytes * inners_per_outer
        out.update({
            "bytes_per_outer": int(bytes_per_outer),
            "MB_per_outer": round(bytes_per_outer / 1e6, 3),
            "allreduces_per_outer": round(
                d1["ops"].get("all-reduce", {"count": 0})["count"]
                + per_inner_ar * inners_per_outer, 1),
            "inners_per_outer": inners_per_outer,
        })
    return out


# (mesh_n, mesh_nz) per IAEA-3D scale
SCALES = {
    "988k": dict(mesh_n=6, mesh_nz=4),
    "2.6M": dict(mesh_n=8, mesh_nz=6),
    "3.5M": dict(mesh_n=8, mesh_nz=8),
}

# candidate device topologies: (label, mesh shape or None for 1D, grid axes)
TOPOLOGIES = {
    4: [("z4", None, 0), ("y4", None, 1), ("z2y2", (2, 2), (0, 1))],
    8: [("z8", None, 0), ("y8", None, 1), ("z4y2", (4, 2), (0, 1)),
        ("z2y4", (2, 4), (0, 1))],
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scales", default="988k,2.6M,3.5M")
    p.add_argument("--n-devices", type=int, default=4, choices=sorted(TOPOLOGIES))
    p.add_argument("--inners-per-outer", type=float, default=None,
                   help="measured CG inners per outer, for per-outer totals")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.n_devices}"
        ).strip()
    os.environ.setdefault("NEUTFEM_X64", "0")

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= args.n_devices

    import jax.numpy as jnp

    from neutfem_jax import config
    from neutfem_jax.parallel import (device_mesh, shard_context, shard_state,
                                      sharded_power_iteration)

    from .data import BENCHMARKS
    from .runner import BenchmarkRun

    rows = []
    for scale in args.scales.split(","):
        cfg = SCALES[scale]
        run = BenchmarkRun(BENCHMARKS["iaea3d"], mesh_n=cfg["mesh_n"],
                           mesh_nz=cfg["mesh_nz"], verbose=False)
        s = run.solver
        s.set_tol(1e-5, 1e-4, 1e-4, 200, 1000)
        fes, ng = s._fes, s._ng
        ctx = s._ctx("exact")
        opts = s._opts("exact")
        shape = fes.mesh.shape
        phi0 = jnp.ones((ng, *shape, fes.P), dtype=config.real_dtype)
        for label, mshape, gaxes in TOPOLOGIES[args.n_devices]:
            ndv = args.n_devices
            ax_list = [gaxes] if isinstance(gaxes, int) else list(gaxes)
            sizes = [ndv] if mshape is None else list(mshape)
            if any(shape[a] % n for a, n in zip(ax_list, sizes)):
                continue  # this topology does not divide this mesh
            mesh = device_mesh(ndv, shape=mshape)
            ctx_sh = shard_context(ctx, mesh, fes, grid_axis=gaxes)
            phi_sh = shard_state(phi0, mesh, grid_axis=gaxes)
            runf, _ = sharded_power_iteration(fes, ng, opts, mesh,
                                              grid_axis=gaxes)
            lowered = runf.lower(ctx_sh, phi_sh, 1.0)
            txt = lowered.compile().as_text()
            summ = summarize(collective_inventory(txt))
            acct = accounting_for(summ, ng, args.inners_per_outer)
            row = {
                "scale": scale, "mesh": f"{shape}", "topology": label,
                "n_devices": ndv, "ng": ng,
                "per_depth": summ, "accounting": acct,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            del ctx_sh, phi_sh
        del ctx, run, s
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
