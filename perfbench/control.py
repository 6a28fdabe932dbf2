"""Read the numbers a cell compares, for the program and for its control,
on several seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

For each seed one run of the cell as ``run.py`` makes it, and beside the
program's numbers the fp8 control's: the float32 reference put in the
program's place with every weight matmul's operands rounded to float8
e4m3, the step below the bf16 the configurations state, judged by the
same rule as the program (``control_correct``, which has to come out
false, and each of its numbers beside its limit). A cell's limits
(``perfbench/limits/<cell>.json``) are set between the largest reading
of sound runs and the smallest reading of the control. One JSON line per
seed. The benchmark's own runs never run the control.
"""

import time

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv) -> int:
    import argparse
    import json

    import torch

    from perfbench.harness import bench, score, serve

    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench: the control reads on the card only",
              file=sys.stderr)
        return 2
    cell = bench.Cell(args.workload)
    driver = {"serve": serve, "score": score}[cell.mix["kind"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        out = driver.run(cell.config, cell.mix, cell.limits, seed=seed,
                         seconds=args.seconds, trace=False,
                         device=torch.device("cuda", 0),
                         t_start=time.perf_counter(), control=True)
        metrics = bench.read_metrics(cell.end_to_end(), out["run"])
        print(json.dumps({
            "seed": seed, "correct": out["correct"],
            "program": out["numbers"],
            "control": out["control"],
            "control_correct": out["control_correct"],
            "control_checks": out["control_checks"],
            "metrics": {k: m["value"] for k, m in metrics.items()},
            "memory_peak_bytes": out["memory_peak_bytes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
