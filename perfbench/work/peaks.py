"""One NVIDIA H100 SXM's data-sheet peaks (dense, at its 700 W limit)."""

PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_INT8 = 1979e12         # OP/s, int8 tensor cores
HBM_BYTES_S = 3.35e12       # bytes/s
