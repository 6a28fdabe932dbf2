"""Share of each fixed-shape prefill wave's rows that are prompt tokens:
the engine's prefill tokens ÷ (its prefill dispatches × slots × chunk),
over the steady stretch of the window before the profiler starts."""


def read(run):
    e = run.engine
    if run.kind != "serve" or not e.get("prefill_dispatches"):
        return None
    rows = e["prefill_dispatches"] * run.shape["slots"] * run.shape["chunk"]
    return 100.0 * e["prefill_tokens"] / rows
