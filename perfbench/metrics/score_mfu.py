"""A scoring call's share of the card's bf16 peak: the FLOPs the
traced calls need (weight matmuls and head of every token, the dense
leading layers' attention) over their seconds × 989 TFLOP/s."""

from perfbench.work import model as M
from perfbench.work.peaks import PEAK_BF16


def read(run):
    if run.kind != "score" or not run.traced_calls:
        return None
    flops = M.score_flops(run.spec, run.mix["batch"], run.mix["seq_len"])
    wall = sum(c.end - c.start for c in run.traced_calls)
    return 100.0 * flops * len(run.traced_calls) / (wall * PEAK_BF16)
