"""The whole decode step's share of the card's peak: for each decode step
of the window's steady stretch before the profiler starts, the least
time its work needs (weights read once, the dense layers' keys and
values, B1's and B2's work; FLOPs at the bf16 peak and the filter's
operations at the int8 peak), summed, over the engine's synchronised
decode time of those steps."""

from perfbench.work import model as M


def read(run):
    e = run.engine
    if run.kind != "serve" or not e.get("decode_time"):
        return None
    bound = sum(M.step_bound_s(*M.decode_step(run.spec, t.decode_lengths))
                for t in run.steady_ticks if t.decode_lengths)
    return 100.0 * bound / e["decode_time"] if bound else None
