"""``chip_smoke.py``'s small-model check, rehearsed on the CPU: the
serve-smoke model in bf16 with the gathers (B2, B4) as the card runs
them against the same model with their plain versions. Rounding the
gathers' outputs differently must pass; a softmax scale off by 10 % or
a mask admitting one more key must fail. (Faults smaller than that are
for the per-kernel comparison at ``gather_within_tolerance``.)"""

import pytest
import torch

import chip_smoke
from repro_torch.kernels import mpmrf_decode as dk
from repro_torch.kernels import mpmrf_prefill as pk


def _one_ulp(fn):
    def wrapper(*a, **kw):
        out = fn(*a, **kw)
        return (out.view(torch.int16) + 1).view(out.dtype)
    return wrapper


def _scale(fn):
    def wrapper(*a, **kw):
        kw["scale"] = 1.1 / a[0].shape[-1] ** 0.5
        return fn(*a, **kw)
    return wrapper


def _mask_plus_one(fn):
    # B2: the length mask lets key ``cache_length`` in; B4: the causal
    # mask lets ``qpos + 1`` in
    arg = 6 if fn is dk.paged_decode_gather_attention else 1

    def wrapper(*a, **kw):
        a = list(a)
        a[arg] = a[arg] + 1
        return fn(*a, **kw)
    return wrapper


@pytest.mark.parametrize("fault, passes", [
    (_one_ulp, True), (_scale, False), (_mask_plus_one, False)],
    ids=["one-ulp", "scale+10%", "mask+1"])
def test_small_model_check_separates_rounding_from_faults(
        monkeypatch, fault, passes):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    for mod, name in ((dk, "paged_decode_gather_attention"),
                      (pk, "paged_prefill_gather_attention")):
        monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    if passes:
        chip_smoke.small_reference_check()
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.small_reference_check()


def _offset_plus_one(fn):
    # B10: the causal mask lets key ``q_offset + i + 1`` in
    def wrapper(*a, **kw):
        kw["q_offset"] = kw.get("q_offset", 0) + 1
        return fn(*a, **kw)
    return wrapper


@pytest.mark.parametrize("fault, passes", [
    (_one_ulp, True), (_scale, False), (_offset_plus_one, False)],
    ids=["one-ulp", "scale+10%", "mask+1"])
def test_small_scoring_check_separates_rounding_from_faults(
        monkeypatch, fault, passes):
    """The same for the scoring check: B10 as the card runs it against
    its plain version, in the serve-smoke model's one sparse layer."""
    from repro_torch.kernels import block_sparse_attention as bsa

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(bsa, "block_sparse_attention",
                        fault(bsa.block_sparse_attention))
    if passes:
        chip_smoke.small_scoring_check()
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.small_scoring_check()
