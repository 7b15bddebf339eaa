"""Device time per named scope from one `jax.profiler` trace.

Reads the newest `*.xplane.pb` under a trace directory (what
`fem map --profile DIR` writes), takes the GPU planes' op events and
reports: the device busy time (union of op intervals) and idle share over
the traced window, and for each scope name given, the device time of the
ops that carry it (by op name or by any stat value, e.g. the `tf_op`
name stack that `jax.named_scope` sets) and its share of busy time.

    python tools/trace_share.py TRACE_DIR verify filter_tail [--top 25]

Prints one JSON object; `--top` adds the longest op names with their
stats, for reading a trace by hand.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _op_events(plane):
    """(line name, events) of the lines that hold one event per device
    op: "XLA Ops" when the plane has it, else every stream line."""
    lines = list(plane.lines)
    ops = [ln for ln in lines if ln.name == "XLA Ops"]
    if not ops:
        ops = [ln for ln in lines if ln.name.startswith("Stream")]
    for ln in ops:
        for ev in ln.events:
            yield ln.name, ev


def _busy_ns(intervals) -> int:
    busy = 0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def summarize(trace_dir: str, scopes: list[str], top: int = 0) -> dict:
    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(max(files, key=os.path.getmtime))
    out = {"planes": {}, "scopes": {}}
    per_name: dict = {}
    intervals = []
    scope_ns = {s: 0 for s in scopes}
    total_ns = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        out["planes"][plane.name] = {
            ln.name: sum(1 for _ in ln.events) for ln in plane.lines
        }
        for _, ev in _op_events(plane):
            dur = int(ev.duration_ns)
            start = int(ev.start_ns)
            intervals.append((start, start + dur))
            total_ns += dur
            stats = {str(k): str(v) for k, v in ev.stats}
            text = ev.name + " " + " ".join(stats.values())
            for s in scopes:
                if s in text:
                    scope_ns[s] += dur
            agg = per_name.setdefault(ev.name, [0, 0, stats])
            agg[0] += dur
            agg[1] += 1
    if not intervals:
        raise ValueError("the trace holds no GPU op events")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _busy_ns(intervals)
    out["op_time_ns"] = total_ns
    out["busy_ns"] = busy
    out["window_ns"] = window
    out["idle_share"] = 1 - busy / window if window else 0.0
    for s in scopes:
        out["scopes"][s] = {
            "device_ns": scope_ns[s],
            "share_of_op_time": scope_ns[s] / total_ns if total_ns else 0.0,
        }
    if top:
        out["top"] = [
            {"name": n, "ns": v[0], "count": v[1], "stats": v[2]}
            for n, v in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
        ]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("scopes", nargs="*")
    ap.add_argument("--top", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(summarize(args.trace_dir, args.scopes, args.top)))


if __name__ == "__main__":
    main()
