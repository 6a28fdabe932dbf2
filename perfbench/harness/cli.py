"""``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell, one JSON line at the end of
standard output.

With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read over a traced sub-window, the
device's busy and traced seconds and the breakdown. Either way the run
checks what its timed path produced against the float32 reference and
prints each number compared beside its limit, last on standard error
and last in the line. It refuses to run without the card the cell asks
for, and prints no result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device, count: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def execute(args: argparse.Namespace, *, t_start: float) -> Optional[Dict]:
    """One run; the result's dict, or None when the run may not report
    (no card, or a forbidden module loaded)."""
    import torch

    from perfbench.harness import bench, score, serve

    cell = bench.Cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return None
    device = torch.device("cuda", 0)
    driver = {"serve": serve, "score": score}[cell.mix["kind"]]
    out = driver.run(cell.config, cell.mix, cell.limits, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device=device, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return None
    run = out["run"]
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if args.trace:
        tr = run.tracer
        if not tr.done:
            raise RuntimeError("the run ended before its traced span")
        result["metrics"] = bench.read_metrics(cell.per_layer(), run)
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["device"] = dev
        result["breakdown"] = tr.breakdown()
    else:
        result["metrics"] = bench.read_metrics(cell.end_to_end(), run)
        result["device"] = dev
    result["checks"] = out["checks"]
    return result


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    result = execute(args, t_start=t_start)
    if result is None:
        return 2
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        bound = (f"at most {c['max']}" if "max" in c
                 else f"at least {c['min']}")
        print(f"check {name}: {c['value']!r} ({bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
