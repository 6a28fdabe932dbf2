"""95th percentile of every gap between consecutive output tokens of one
request whose later token was committed in the window, over all
requests."""

from perfbench.harness.stats import percentile


def read(run):
    if run.kind != "serve":
        return None
    gaps = [b - a for r in run.requests
            for a, b in zip(r.token_times, r.token_times[1:])
            if run.in_window(b)]
    return 1e3 * percentile(gaps, 95) if gaps else None
