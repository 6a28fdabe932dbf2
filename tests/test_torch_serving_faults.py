"""``serving_faults`` — what ``ServeLoop`` refuses at construction because
it would fail mid-run — for the shapes the CUDA kernels refuse and for
windowed layers, on the CPU.

Told that the kernels launch (a CUDA device), it gives one reason each
for a head dim the kernels do not take (192, past 128; the reference
test models' 8), an fp32 engine and a query block past the filter's
128; on the CPU, where the plain versions take every shape, it gives
none for the same configs; phi3-mini's full-width pallas engine (head
dim 96, G = 1) gets none on either. A windowed model whose windowed
layers (off the fused kernels) would mask past ``chunk_threshold`` is
refused at construction; the same model without windows is not. The
card's twin, a ``pallas`` engine at head dim 192 refused before any
launch, is in ``test_torch_cuda.py``."""

import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_serve_config
from repro_torch.core.energon_attention import serving_faults
from repro_torch.models import LMModel
from repro_torch.runtime import ServeLoop

#: the full-width serving Energon config: pallas, key / page blocks of
#: 64, query block 128, planes resident from 1024 rows
ENERGON = get_serve_config("qwen3-14b").energon
GROUP, CHUNK, CACHE = 5, 128, 4096


@pytest.mark.parametrize("overrides, reason", [
    (dict(head_dim=192), "head_dim 192 must be a multiple of 16, <= 128"),
    (dict(head_dim=8), "head_dim 8 must be a multiple of 16, <= 128"),
    (dict(dtype=torch.float32), "take bfloat16 q/K/V"),
    # G·chunk = 1280 rows in query blocks of 256: the fused prefill
    # engages, and its filter takes query blocks up to 128
    (dict(query_block=256, chunk=256, cache_len=2048),
     "query_block 256 must be a multiple of 16, <= 128"),
], ids=["hd192", "hd8", "fp32", "qb256"])
def test_kernel_shapes_are_refused_where_the_kernels_launch(overrides,
                                                            reason):
    kw = dict(group=GROUP, chunk=CHUNK, cache_len=CACHE, head_dim=128,
              dtype=torch.bfloat16)
    cfg = ENERGON
    if "query_block" in overrides:
        cfg = dataclasses.replace(cfg, query_block=overrides["query_block"])
    kw.update({k: v for k, v in overrides.items() if k != "query_block"})
    faults = serving_faults(cfg, cuda_kernels=True, **kw)
    assert len(faults) == 1 and reason in faults[0], faults
    assert faults[0].startswith("the CUDA kernels refuse")
    assert serving_faults(cfg, **kw) == []
    assert serving_faults(cfg, cuda_kernels=False, **kw) == []
    # nothing to refuse at the kernels' own shapes
    assert serving_faults(ENERGON, group=GROUP, chunk=CHUNK, cache_len=CACHE,
                          head_dim=128, dtype=torch.bfloat16,
                          cuda_kernels=True) == []


def test_no_kernel_reason_where_no_kernel_launches():
    """The XLA impls launch no kernel; nor does a model whose sparse
    layers are all windowed."""
    kw = dict(group=GROUP, chunk=CHUNK, cache_len=CACHE, head_dim=8,
              dtype=torch.float32, cuda_kernels=True)
    xla = dataclasses.replace(ENERGON, impl="mpmrf_block")
    assert serving_faults(xla, **kw) == []
    assert serving_faults(ENERGON, windows=[0, 0] + [16] * 4, **kw) == []
    assert len(serving_faults(ENERGON, windows=[16] * 5 + [0], **kw)) == 2


def _gemma_narrow(sliding_window=16, threshold=256 * 1024):
    """gemma3-27b's serving config (G = 2, 5 windowed : 1 global) at a
    narrow width, every layer sparse, and a chunk_threshold that a chunk
    of 128 rows against 2048 cache rows passes over."""
    cfg = get_serve_config("gemma3-27b")
    return dataclasses.replace(
        cfg, num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
        sliding_window=sliding_window,
        energon=dataclasses.replace(cfg.energon, min_prune_layer=0,
                                    chunk_threshold=threshold))


def test_windowed_prefill_past_the_threshold_is_refused_at_construction():
    model = LMModel(_gemma_narrow(), device="cpu")
    with pytest.raises(ValueError, match="windowed layers .* would mask "
                       "256 folded rows × 2048 keys, past chunk_threshold"):
        ServeLoop(model, model.init(), max_len=2048, prefill_chunk=128,
                  device="cpu")
    # without windows every layer takes the fused prefill, which masks
    # nothing: no refusal
    plain = LMModel(_gemma_narrow(sliding_window=0), device="cpu")
    assert plain.layer_windows() is None
    engine = ServeLoop(plain, plain.init(), max_len=2048, prefill_chunk=128,
                       device="cpu")
    assert engine.max_len == 2048


def test_phi3_pallas_engine_is_not_refused():
    """phi3-mini's serving config: the fused path at head dim 96 and
    G = 1, the phase shapes of the card (chunk 128, max_len 4096)."""
    cfg = get_serve_config("phi3-mini-3.8b")
    assert cfg.energon.impl == "pallas" and cfg.head_dim == 96
    for paged in (True, False):
        assert serving_faults(
            cfg.energon, group=1, chunk=CHUNK, cache_len=CACHE, paged=paged,
            head_dim=96, dtype=torch.bfloat16, cuda_kernels=True) == []


def test_cpu_engines_are_not_newly_refused():
    """On the CPU the plain versions take phi3-mini's head dim of 96 and
    fp32 on the fused path: the engine builds."""
    cfg = dataclasses.replace(
        get_serve_config("phi3-mini-3.8b", smoke=True), num_layers=3,
        d_model=192, num_heads=2, num_kv_heads=2, head_dim=96)
    model = LMModel(cfg, device="cpu")
    assert cfg.energon.impl == "pallas" and model.dtype == torch.float32
    ServeLoop(model, model.init(), max_len=64, prefill_chunk=16,
              device="cpu")
