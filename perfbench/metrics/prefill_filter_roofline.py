"""B3's share of its roofline in the traced prefill waves: the least time
the card needs for the filter's work on every sparse layer (from each
chunk's rows, the harness's own count) over B3's device time in the
trace (B4 has its own, ``prefill_sparse_roofline``)."""

from perfbench.work import kernels as K

KERNELS = (r"\bprefill_filter_kernel<",)


def read(run):
    if run.kind != "serve" or run.tracer is None or not run.tracer.done:
        return None
    spec = run.spec
    en = spec["energon"]
    kv, hd = spec["num_key_value_heads"], spec["head_dim"]
    g = spec["num_attention_heads"] // kv
    sparse = spec["num_hidden_layers"] - en["dense_layers"]
    bound = sum(
        sparse * K.bound_s(K.prefill_filter(
            t.prefill_rows, kv, g, hd, en["query_block"],
            en["decode_key_block"], run.shape["chunk"]))
        for t in run.ticks if t.prefill_rows)
    seconds = run.tracer.seconds(KERNELS)
    return 100.0 * bound / seconds if bound and seconds else None
