"""B1 + B2's share of their roofline in the traced decode steps: the least
time the card needs for the filter's and the gather's work on every
sparse layer (from the slots' cache lengths, the harness's own count)
over the device time of those kernels in the trace."""

from perfbench.work import kernels as K

KERNELS = (r"\bdecode_filter_kernel<", r"\bdecode_split_kernel<")


def read(run):
    if run.kind != "serve" or run.tracer is None or not run.tracer.done:
        return None
    spec = run.spec
    en = spec["energon"]
    kv, hd = spec["num_key_value_heads"], spec["head_dim"]
    g = spec["num_attention_heads"] // kv
    sparse = spec["num_hidden_layers"] - en["dense_layers"]
    bound = 0.0
    for tick in run.ticks:
        if tick.decode_lengths:
            bk = en["decode_key_block"]
            bound += sparse * (
                K.bound_s(K.decode_filter(tick.decode_lengths, kv, g, hd, bk))
                + K.bound_s(K.decode_gather(tick.decode_lengths, kv, g, hd,
                                            bk, en["pruning_ratio"])))
    seconds = run.tracer.seconds(KERNELS)
    return 100.0 * bound / seconds if bound and seconds else None
