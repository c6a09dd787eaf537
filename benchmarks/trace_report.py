"""Per-kernel device-time accounting from a ``NEUTFEM_PROFILE`` trace.

The analogue of the reference's per-phase chrono report
(/root/reference/src/NeutFEM.cpp:1688-1700): where the reference times whole
solver phases on the host, the JAX profiler gives per-op device time.  This
tool makes that parsing reproducible.

    NEUTFEM_PROFILE=/tmp/tr python -m benchmarks.iaea3d --mesh 4x4x2 --order 2
    python -m benchmarks.trace_report /tmp/tr [--top 25] [--json out.json]

Reads every ``*.xplane.pb`` under the trace dir (the profiler writes
``plugins/profile/<ts>/``) with ``jax.profiler.ProfileData``.  On a GPU trace it
keeps the device planes (``/device:GPU:<n>``): the "XLA Ops" line where the
plane has one (events named by HLO op), else the stream lines (kernel
launches).  A CPU-only trace has no device plane; its XLA op events on
``/host:CPU`` are kept instead, so the tool stays usable for CPU runs.  Events
are grouped by op name with device time, occurrences and, where the profiler
records it, bytes accessed and the resulting GB/s.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
from typing import Dict, List

__all__ = ["load_device_events", "aggregate", "main"]


def _xplane_files(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))


def _event(ev, line: str) -> Dict:
    return {"name": ev.name, "dur": ev.duration_ns / 1e3, "ts": ev.start_ns / 1e3,
            "line": line, "args": {k: v for k, v in ev.stats}}


def load_device_events(trace_dir: str) -> List[Dict]:
    """Device events ({name, dur (us), ts (us), line, args}) of every GPU plane,
    or the XLA op events of the host CPU plane when the trace has no GPU."""
    import jax

    events: List[Dict] = []
    fallback: List[Dict] = []
    for path in _xplane_files(trace_dir):
        data = jax.profiler.ProfileData.from_file(path)
        for plane in data.planes:
            if plane.name.startswith("/device:GPU"):
                lines = list(plane.lines)
                ops = [ln for ln in lines if ln.name == "XLA Ops"]
                for ln in ops or [ln for ln in lines if ln.name.startswith("Stream")]:
                    events.extend(_event(ev, ln.name) for ev in ln.events)
            elif plane.name == "/host:CPU":
                for ln in plane.lines:
                    for ev in ln.events:
                        if any(k == "hlo_op" for k, _ in ev.stats):
                            fallback.append(_event(ev, ln.name))
    return events if events else fallback


def aggregate(events: List[Dict]) -> List[Dict]:
    """Group device events by op name; sum duration, keep bytes/category."""
    agg: Dict[str, Dict] = collections.defaultdict(
        lambda: {"us": 0.0, "count": 0, "bytes": 0, "category": ""})
    for ev in events:
        name = ev.get("name", "?")
        a = ev.get("args", {}) or {}
        row = agg[name]
        row["us"] += float(ev.get("dur", 0.0))
        row["count"] += 1
        for k in ("bytes_accessed", "bytes accessed"):
            if k in a:
                try:
                    row["bytes"] += int(float(a[k]))
                except (TypeError, ValueError):
                    pass
                break
        cat = a.get("hlo_category") or a.get("category") or ""
        if cat:
            row["category"] = cat
    rows = []
    for name, r in agg.items():
        us = r["us"]
        rows.append({
            "op": name, "device_us": round(us, 1), "count": r["count"],
            "us_per_call": round(us / max(r["count"], 1), 2),
            "bytes": r["bytes"], "category": r["category"],
            "gbps": round(r["bytes"] / us / 1e3, 1) if us > 0 and r["bytes"] else None,
        })
    rows.sort(key=lambda r: -r["device_us"])
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trace_dir")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    events = load_device_events(args.trace_dir)
    rows = aggregate(events)
    total = sum(r["device_us"] for r in rows)
    print(f"# {len(events)} device events, {total/1e3:.2f} ms total device time")
    print("| op | ms | % | calls | us/call | MB | GB/s | category |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows[: args.top]:
        pct = 100.0 * r["device_us"] / total if total else 0.0
        mb = r["bytes"] / 1e6 if r["bytes"] else 0.0
        print(f"| {r['op'][:60]} | {r['device_us']/1e3:.2f} | {pct:.1f} "
              f"| {r['count']} | {r['us_per_call']} | {mb:.1f} "
              f"| {r['gbps'] if r['gbps'] is not None else ''} | {r['category']} |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"total_device_us": total, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
