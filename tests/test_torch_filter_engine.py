"""The shapes the integer filter engine (``kernels/csrc/filter_engine.cuh``)
that runs B3, B7 and B9 admits and refuses, on the CPU: the wrappers'
check before a launch, each refusal with its message. The kernels
themselves, launch geometry included (a query block's key range cut
into runs, the NEG_INF writes of key blocks above every row), are held
to their plain versions on the card (``tests/test_torch_cuda.py``),
which an uncovered or twice-written output would fail."""

import pytest

from repro_torch.kernels import mpmrf_filter as fk


@pytest.mark.parametrize("d,bq,bk", [(16, 16, 8), (32, 48, 64),
                                     (64, 128, 128), (128, 128, 64),
                                     (128, 32, 24)])
def test_filter_engine_admits(d, bq, bk):
    fk.check_filter_launch(d, bq, bk)
    fk.check_filter_launch(d, bq, bk, (2, 4))
    fk.check_filter_launch(d, bq, bk, (1, 8))


@pytest.mark.parametrize("d,bq,bk,round_bits,message", [
    (8, 16, 16, None, "head_dim 8 not in (16, 32, 64, 128)"),
    (128, 24, 64, None, "query_block 24 must be a multiple of 16, <= 128"),
    (128, 256, 64, None, "query_block 256 must be a multiple of 16, <= 128"),
    (128, 128, 4, None, "key_block 4 must be a multiple of 8, <= 128"),
    (128, 128, 12, None, "key_block 12 must be a multiple of 8, <= 128"),
    (128, 128, 256, None, "key_block 256 must be a multiple of 8, <= 128"),
    (128, 128, 64, (0, 8), "plane widths must satisfy 1 <= lo < hi <= 8"),
    (128, 128, 64, (4, 4), "plane widths must satisfy 1 <= lo < hi <= 8"),
    (128, 128, 64, (2, 9), "plane widths must satisfy 1 <= lo < hi <= 8"),
])
def test_filter_engine_refuses(d, bq, bk, round_bits, message):
    """Shapes the engine does not take, each with its message: d 8 (the
    reference's test shape), query blocks off the 16-row m-tiles or past
    eight warps, key blocks off the 8-key n-tiles or past the ring, and
    plane widths outside 1 ≤ lo < hi ≤ 8 (both planes are derived from
    the codes' high bytes by a packed shift of 8 − bits < 8)."""
    with pytest.raises(ValueError, match=message.replace("(", r"\(")
                       .replace(")", r"\)")):
        fk.check_filter_launch(d, bq, bk, round_bits)
