"""Milliseconds a prefill wave takes: the engine's synchronised prefill
time ÷ its prefill dispatches, over the steady stretch of the window
before the profiler starts."""


def read(run):
    e = run.engine
    if run.kind != "serve" or not e.get("prefill_dispatches"):
        return None
    return 1e3 * e["prefill_time"] / e["prefill_dispatches"]
