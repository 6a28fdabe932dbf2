"""B9's share of its roofline in the traced scoring calls: the least time
the card needs for the filter's work on every sparse layer of every
sequence over B9's device time in the trace."""

from perfbench.work import kernels as K

KERNELS = (r"\bfilter_scores_kernel<",)


def read(run):
    t = run.tracer
    if run.kind != "score" or t is None or not t.done or not run.traced_calls:
        return None
    spec, mix = run.spec, run.mix
    en = spec["energon"]
    sparse = spec["num_hidden_layers"] - en["dense_layers"]
    one = K.bound_s(K.sequence_filter(
        mix["batch"], spec["num_attention_heads"],
        spec["num_key_value_heads"], mix["seq_len"], spec["head_dim"],
        en["query_block"], en["key_block"]))
    seconds = run.tracer.seconds(KERNELS)
    bound = len(run.traced_calls) * sparse * one
    return 100.0 * bound / seconds if seconds else None
