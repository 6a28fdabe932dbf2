"""B10's share of its roofline in the traced scoring calls: the least
time the card needs for the sparse layers' gathered attention, every
query block of every sequence at its live budget, over B10's device time
in the trace."""

from perfbench.work import kernels as K

KERNELS = (r"\bblock_sparse_attention_kernel<",)


def read(run):
    t = run.tracer
    if run.kind != "score" or t is None or not t.done or not run.traced_calls:
        return None
    spec, mix = run.spec, run.mix
    en = spec["energon"]
    sparse = spec["num_hidden_layers"] - en["dense_layers"]
    one = K.bound_s(K.sequence_sparse(
        mix["batch"], spec["num_attention_heads"],
        spec["num_key_value_heads"], mix["seq_len"], spec["head_dim"],
        en["query_block"], en["key_block"], en["pruning_ratio"]))
    seconds = t.seconds(KERNELS)
    bound = len(run.traced_calls) * sparse * one
    return 100.0 * bound / seconds if seconds else None
