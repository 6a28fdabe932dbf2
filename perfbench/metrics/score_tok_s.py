"""Tokens of every scoring call that completed in the window ÷ the
window's seconds; the window closes at the end of the call running when
``--seconds`` elapsed."""


def read(run):
    if run.kind != "score" or not run.calls:
        return None
    return sum(c.tokens for c in run.calls) / run.window_s
