"""The whole prefill wave's share of the card's peak: for each wave of
the window's steady stretch before the profiler starts, the least time
its prompt rows need (weights read once, the weight matmuls of the real
rows, the head for prompts that end, the dense layers' attention, B3's
work), summed, over the engine's synchronised prefill time of those
waves. Padding rows count as no work."""

from perfbench.work import model as M


def read(run):
    e = run.engine
    if run.kind != "serve" or not e.get("prefill_time"):
        return None
    bound = sum(M.step_bound_s(*M.prefill_wave(
        run.spec, t.prefill_rows, t.prefill_finishing, run.shape["chunk"]))
        for t in run.steady_ticks if t.prefill_rows)
    return 100.0 * bound / e["prefill_time"] if bound else None
