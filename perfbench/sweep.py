"""Find a serving cell's knee: the highest offered rate whose backlog does
not grow over a window.

    python3 perfbench/sweep.py --workload <serving cell> --seed <n> \\
        --rates 0.4,0.6,0.8 --seconds <s>

One engine is set up once; each rate then runs the cell's mix with that
rate (its pre-roll and its window; no wait for late first tokens, which
count as censored), and what is left in flight is cancelled before the
next. The sweep stops after two rates in a row that are not sustained.
Per rate one JSON line: the offered rate, the cell's end-to-end metrics,
the requests queued at the window's start and end and the backlog's
slope over the window (requests per second, least squares), and whether
the rate is sustained: the slope under ``--slope`` and at most one
request queued at the end. The cell then offers four fifths of the
highest rate sustained.
"""

import time

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def slope(points) -> float:
    """Least-squares slope of ``(t, y)`` points."""
    n = len(points)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in points) / n
    my = sum(y for _, y in points) / n
    var = sum((t - mt) ** 2 for t, _ in points)
    return sum((t - mt) * (y - my) for t, y in points) / var if var else 0.0


def main(argv) -> int:
    import argparse
    import json

    import torch

    from perfbench.harness import bench, serve

    ap = argparse.ArgumentParser(prog="perfbench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--slope", type=float, default=0.02)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench: the sweep runs on the card only", file=sys.stderr)
        return 2
    cell = bench.Cell(args.workload)
    t0 = time.perf_counter()
    eng = serve.Serving(cell.config, cell.mix, seed=args.seed,
                        device=torch.device("cuda", 0))
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    misses = 0
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(cell.mix, rate_per_s=rate, grace_s=0)
        rec, _ = eng.window(mix, args.seconds, trace=False,
                            uid0=(i + 1) * 100000)
        metrics = bench.read_metrics(cell.end_to_end(), rec)
        inside = [p for p in rec.backlog if p[0] >= 0]
        s = slope(inside)
        end = inside[-1][1] if inside else 0
        sustained = s < args.slope and end <= 1
        print(json.dumps({
            "rate_per_s": rate,
            "metrics": {k: m["value"] for k, m in metrics.items()
                        if k != "setup_s"},
            "queued_start": inside[0][1] if inside else 0,
            "queued_end": end, "backlog_slope": s,
            "sustained": sustained}), flush=True)
        eng.clear()
        misses = 0 if sustained else misses + 1
        if misses == 2:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
