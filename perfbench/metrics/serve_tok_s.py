"""Output tokens committed in the window ÷ the window's seconds, over
every request (those sent in the pre-roll too)."""


def read(run):
    if run.kind != "serve":
        return None
    n = sum(1 for r in run.requests for t in r.token_times
            if run.in_window(t))
    return n / run.window_s
