"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``_build`` for how they are built, bound and counted).

========================================  =============================
kernel                                    replaces (TPU, Pallas)
========================================  =============================
``mpmrf_decode.paged_filter_scores``      B1 ``mpmrf_decode.py::
                                          mpmrf_paged_filter_scores``
``mpmrf_decode.paged_decode_gather_       B2 ``mpmrf_decode.py::
attention``                               paged_decode_gather_attention``
``mpmrf_prefill.paged_prefill_filter_     B3 ``mpmrf_prefill.py::
scores``                                  mpmrf_paged_prefill_filter_
                                          scores``
``mpmrf_prefill.paged_prefill_gather_     B4 ``mpmrf_prefill.py::
attention``                               paged_prefill_gather_attention``
========================================  =============================

The filter kernels (B1, B3) equal their plain versions bit for bit. The
bf16 gathers (B2, B4) and their plain versions both compute in f32 from
the same bf16 inputs and round the output once, so an element differs
by at most one bf16 ulp (≤ 2⁻⁷·|v|): :func:`gather_within_tolerance`
allows two, plus a floor for outputs near 0.
"""

GATHER_ATOL = 1e-3
GATHER_RTOL = 1.6e-2


def gather_within_tolerance(out, ref) -> bool:
    """|out − ref| ≤ GATHER_ATOL + GATHER_RTOL·|ref| everywhere."""
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs()
                 <= GATHER_ATOL + GATHER_RTOL * ref.abs()).all())
