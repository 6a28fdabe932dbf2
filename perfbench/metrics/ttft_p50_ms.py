"""Median time to first token of every request due in the window, timed
from when it was due; a request still without one when the harness
stopped waiting counts as beyond every observed one."""

from perfbench.harness.stats import percentile


def read(run):
    if run.kind != "serve":
        return None
    due = [r for r in run.requests if run.in_window(r.due)]
    seen = [r.token_times[0] - r.due for r in due if r.token_times]
    cut = [run.censor_time - r.due for r in due if not r.token_times]
    if not due:
        return None
    return 1e3 * percentile(seen, 50, cut)
