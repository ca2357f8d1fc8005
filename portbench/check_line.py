"""Check a run's last line against ``BENCHMARK.json``.

    python portbench/check_line.py --workload <cell> --trace <0|1> \
        [--file out.txt] [--platform gpu]

Reads the run's standard output (``--file``, or standard input) and
checks its last line: a JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` and ``device``; every metric the cell lists for
that mode (end-to-end without trace, per-layer with) and no other, each
a finite number in its unit; a share of a roofline or a peak at most
105 %; ``device`` with the platform, the card's name, the count of cards
the cell asks for and the memory peak, and with trace ``busy_s`` above 0
and at most ``window_s``; a ``breakdown`` of at most 10 entries a list;
``checks`` as the last key.  Prints ``ok`` or each problem, and exits 0
or 1.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


def _number(v) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v))


def problems(line: str, bench: Dict, workload: str, trace: bool,
             platform: str = "gpu") -> List[str]:
    cell = next((c for c in bench["workloads"] if c["name"] == workload),
                None)
    if cell is None:
        return [f"no workload {workload!r} in BENCHMARK.json"]
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        return [f"the last line is not JSON: {e}"]
    if not isinstance(obj, dict):
        return ["the last line is not a JSON object"]
    out = []
    for key, kind in (("correct", bool), ("attempted", int),
                      ("failed", int), ("metrics", dict), ("device", dict)):
        if not isinstance(obj.get(key), kind):
            out.append(f"{key} missing or not {kind.__name__}")
    if out:
        return out
    want = {m["name"]: m for m in bench["per_layer" if trace
                                        else "end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}
    got = obj["metrics"]
    for name, m in want.items():
        if name not in got:
            out.append(f"metrics lacks {name}")
            continue
        v = got[name]
        if not isinstance(v, dict) or not _number(v.get("value")):
            out.append(f"{name} has no finite value")
        elif v.get("unit") != m["unit"]:
            out.append(f"{name} unit {v.get('unit')!r} != {m['unit']!r}")
        elif (name.endswith("_roofline") or "mfu" in name) \
                and v["value"] > 105:
            out.append(f"{name} reads {v['value']} %, above 105 %")
    for name in got:
        if name not in want:
            out.append(f"metrics has {name}, which this cell does not list "
                       f"for trace={int(trace)}")
    dev = obj["device"]
    if dev.get("platform") != platform:
        out.append(f"device.platform {dev.get('platform')!r} != "
                   f"{platform!r}")
    if not isinstance(dev.get("kind"), str) or not dev.get("kind"):
        out.append("device.kind missing")
    if dev.get("count") != cell["chips"]:
        out.append(f"device.count {dev.get('count')!r} != {cell['chips']}")
    if not isinstance(dev.get("memory_peak_bytes"), int):
        out.append("device.memory_peak_bytes missing or not an integer")
    if trace:
        busy, window = dev.get("busy_s"), dev.get("window_s")
        if not (_number(busy) and _number(window) and 0 < busy <= window):
            out.append(f"device busy_s {busy!r} / window_s {window!r}: "
                       f"need 0 < busy_s <= window_s")
    bd = obj.get("breakdown")
    if bd is not None:
        for key in ("device_ops", "idle_gaps"):
            rows = bd.get(key, [])
            if len(rows) > 10 or not all(
                    isinstance(r, list) and len(r) == 2
                    and isinstance(r[0], str) and _number(r[1])
                    for r in rows):
                out.append(f"breakdown.{key} is not <= 10 [name, seconds]")
    if list(obj)[-1] != "checks" or not isinstance(obj["checks"], dict):
        out.append("the last key is not checks")
    else:
        for name, c in obj["checks"].items():
            if not isinstance(c, dict) or set(c) != {"value", "limit"}:
                out.append(f"checks.{name} is not {{value, limit}}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--file")
    ap.add_argument("--platform", default="gpu")
    args = ap.parse_args(argv)
    text = (Path(args.file).read_text() if args.file
            else sys.stdin.read())
    lines = [ln for ln in text.splitlines() if ln.strip()]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = (problems(lines[-1], bench, args.workload, bool(args.trace),
                      args.platform) if lines else ["no output"])
    for p in found:
        print(f"check_line: {args.workload} trace={args.trace}: {p}")
    if not found:
        print(f"check_line: ok {args.workload} trace={args.trace}")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
