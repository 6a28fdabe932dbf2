"""B11's share of its roofline in the traced scoring calls: the least
time the card needs for the dense leading layers' causal attention over
B11's device time in the trace."""

from perfbench.work import kernels as K

KERNELS = (r"\bflash_attention_kernel<",)


def read(run):
    t = run.tracer
    if run.kind != "score" or t is None or not t.done or not run.traced_calls:
        return None
    spec, mix = run.spec, run.mix
    dense = spec["energon"]["dense_layers"]
    one = K.bound_s(K.flash(
        mix["batch"], spec["num_attention_heads"],
        spec["num_key_value_heads"], mix["seq_len"], spec["head_dim"]))
    seconds = run.tracer.seconds(KERNELS)
    bound = len(run.traced_calls) * dense * one
    return 100.0 * bound / seconds if seconds else None
