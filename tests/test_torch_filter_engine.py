"""The shapes the integer filter engine (``kernels/csrc/filter_engine.cuh``)
that runs B3, B7 and B9, and its decode kind (B1, B5), admit and
refuse, on the CPU: the wrappers' checks before a launch, each refusal
with its message; and the packed shifts with which the kernels derive
the filter planes from the codes' high bytes. The kernels themselves,
launch geometry included (a query block's or a row's key range cut
into runs, the NEG_INF writes of key blocks above every row or past the
length), are held to their plain versions on the card
(``tests/test_torch_cuda.py``), which an uncovered or twice-written
output would fail."""

import numpy as np
import pytest

from repro_torch.kernels import mpmrf_decode as dk
from repro_torch.kernels import mpmrf_filter as fk


@pytest.mark.parametrize("d,bq,bk,round_bits", [
    pytest.param(16, 16, 8, (2, 4), id="16-16-8"),
    pytest.param(32, 48, 64, (2, 4), id="32-48-64"),
    pytest.param(64, 128, 128, (2, 4), id="64-128-128"),
    pytest.param(128, 128, 64, (2, 4), id="128-128-64"),
    pytest.param(128, 32, 24, (2, 4), id="128-32-24"),
    # head dims between the instantiations run the next one up, padded
    pytest.param(96, 128, 64, (2, 4), id="96-128-64"),
    pytest.param(48, 32, 16, (2, 4), id="48-32-16"),
    # lo = 0: the msb plane is the code's sign, a shift by 7
    pytest.param(128, 128, 64, (0, 8), id="128-128-64-lo0-hi8"),
])
def test_filter_engine_admits(d, bq, bk, round_bits):
    fk.check_filter_launch(d, bq, bk)
    fk.check_filter_launch(d, bq, bk, (2, 4))
    fk.check_filter_launch(d, bq, bk, (1, 8))
    fk.check_filter_launch(d, bq, bk, round_bits)


@pytest.mark.parametrize("d,bq,bk,round_bits,message", [
    (8, 16, 16, None, "head_dim 8 must be a multiple of 16, <= 128"),
    (128, 24, 64, None, "query_block 24 must be a multiple of 16, <= 128"),
    (128, 256, 64, None, "query_block 256 must be a multiple of 16, <= 128"),
    (128, 128, 4, None, "key_block 4 must be a multiple of 8, <= 128"),
    (128, 128, 12, None, "key_block 12 must be a multiple of 8, <= 128"),
    (128, 128, 256, None, "key_block 256 must be a multiple of 8, <= 128"),
    (128, 128, 64, (4, 4), "plane widths must satisfy 0 <= lo < hi <= 8"),
    (128, 128, 64, (2, 9), "plane widths must satisfy 0 <= lo < hi <= 8"),
    (128, 128, 64, (-1, 4), "plane widths must satisfy 0 <= lo < hi <= 8"),
])
def test_filter_engine_refuses(d, bq, bk, round_bits, message):
    """Shapes the engine does not take, each with its message: d 8 (the
    reference's test shape), query blocks off the 16-row m-tiles or past
    eight warps, key blocks off the 8-key n-tiles or past the ring, and
    plane widths outside 0 ≤ lo < hi ≤ 8 (both planes are derived from
    the codes' high bytes by a packed shift of at most 7)."""
    with pytest.raises(ValueError, match=_escaped(message)):
        fk.check_filter_launch(d, bq, bk, round_bits)


def _escaped(message):
    return message.replace("(", r"\(").replace(")", r"\)")


def _lane_shift(words, s):
    """The kernels' packed arithmetic right shift by s (0..7) of the four
    int8 lanes of uint32 words (filter_engine.cuh, LaneShift): the logical
    shift masked to the lane, then the lane's sign bit spread over the
    vacated bits by one multiply."""
    mask = np.uint32(0x01010101 * (0xFF >> s))
    sign = np.uint32(0x01010101 * (0x80 >> s))
    fill = np.uint32((2 << s) - 2)
    u = (words >> np.uint32(s)) & mask
    return u | ((u & sign) * fill)


@pytest.mark.parametrize("lo,hi", [(lo, hi) for hi in range(1, 9)
                                   for lo in range(hi)])
def test_plane_shifts_derive_both_planes_from_the_high_byte(lo, hi):
    """For every int16 code and every 0 ≤ lo < hi ≤ 8, the two shifts of
    ``plane_shifts`` applied to the code's high byte (code >> 8) give the
    reference's msb = code >> (16 − lo) and hi = code >> (16 − hi), as
    plain int8 shifts and as the kernels' packed shift of four lanes to a
    word. At lo = 0 the msb plane is the code's sign: the shift by 7."""
    code = np.arange(-32768, 32768, dtype=np.int32)
    high = (code >> 8).astype(np.int8)
    s_msb, s_hi = dk.plane_shifts((lo, hi))
    assert 0 <= s_msb <= 7 and 0 <= s_hi <= 7
    msb, hi_plane = code >> (16 - lo), code >> (16 - hi)
    np.testing.assert_array_equal(high >> s_msb, msb)
    np.testing.assert_array_equal(high >> s_hi, hi_plane)
    words = high.view(np.uint8).view(np.uint32)       # four lanes a word
    for s, want in ((s_msb, msb), (s_hi, hi_plane)):
        got = _lane_shift(words, s).view(np.uint8).view(np.int8)
        np.testing.assert_array_equal(got, want)
    # the remainder rem = hi − (msb << (hi − lo)) reaches 255 at (0, 8):
    # no int8 lane holds it, so the kernels multiply by the hi plane,
    # which always fits
    assert hi_plane.min() >= -128 and hi_plane.max() <= 127


@pytest.mark.parametrize("g,d,bk,round_bits", [
    (1, 16, 8, (2, 4)), (5, 128, 64, (2, 4)), (16, 64, 16, (0, 8)),
    (8, 32, 128, (1, 8)), (9, 128, 24, (3, 7)), (1, 96, 64, (2, 4)),
    (16, 112, 16, (0, 8)),
])
def test_decode_filter_admits(g, d, bk, round_bits):
    """The decode kind takes 1–16 rows (one or two n8 tiles), every head
    dim 16·k ≤ 128 (phi3-mini's 96 at G = 1 among them), key blocks of
    8-key multiples up to 128 (16 in the reference's test models, 64 on
    the card's serving path) and every 0 ≤ lo < hi ≤ 8."""
    dk.check_decode_filter_launch(g, d, bk, round_bits)


@pytest.mark.parametrize("g,d,bk,round_bits,message", [
    (17, 128, 64, (2, 4),
     "the decode filter takes 1 to 16 query rows per bh row (G=17)"),
    (0, 128, 64, (2, 4),
     "the decode filter takes 1 to 16 query rows per bh row (G=0)"),
    (5, 8, 16, (2, 4), "head_dim 8 must be a multiple of 16, <= 128"),
    (5, 128, 4, (2, 4), "key_block 4 must be a multiple of 8, <= 128"),
    (5, 128, 20, (2, 4), "key_block 20 must be a multiple of 8, <= 128"),
    (5, 128, 256, (2, 4), "key_block 256 must be a multiple of 8, <= 128"),
    (5, 128, 64, (4, 4), "plane widths must satisfy 0 <= lo < hi <= 8"),
    (5, 128, 64, (2, 9), "plane widths must satisfy 0 <= lo < hi <= 8"),
])
def test_decode_filter_refuses(g, d, bk, round_bits, message):
    """Shapes the decode kind does not take, each with its message: more
    rows than two n8 tiles, d 8 (the reference's test shape), key blocks
    off the 8-key granule or past the ring, plane widths out of range."""
    with pytest.raises(ValueError, match=_escaped(message)):
        dk.check_decode_filter_launch(g, d, bk, round_bits)
