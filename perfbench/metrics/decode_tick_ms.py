"""Milliseconds a decode tick takes: the engine's synchronised decode time
÷ its decode dispatches, over the steady stretch of the window before
the profiler starts (which would slow the host-bound tick)."""


def read(run):
    e = run.engine
    if run.kind != "serve" or not e.get("decode_dispatches"):
        return None
    return 1e3 * e["decode_time"] / e["decode_dispatches"]
