"""Share of the traced sub-window of a serving run in which no operation
ran on the device (from the profiler's trace)."""


def read(run):
    t = run.tracer
    if run.kind != "serve" or t is None or not t.done or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
