"""The one-card dry run (``repro_torch.launch.dryrun``) on the CPU.

* A smoke config's train, prefill and decode cells lower on the meta
  device (no data, no device memory) into artifacts with the
  reference's keys; ``argument_size_in_bytes`` is the sum of the input
  leaves' bytes, computed here from the model's own constructors.
* ``input_specs`` gives the reference's shapes and dtypes,
  ``microbatches_for`` its counts and ``optimizer_config`` its >20B diet
  for every arch.
* ``main`` writes one cell's JSON artifact; ``--all`` names every
  (arch, shape) of ``shapes_for_arch`` (the cells themselves run at
  full size, minutes each: ``PERF.md``'s table)."""

import dataclasses
import json
import os

import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.models import LMModel
from repro_torch.optim import adamw

#: the reference's artifact keys (``repro.launch.dryrun.lower_cell``)
REF_KEYS = {"arch", "shape", "kind", "mesh", "chips", "compile_seconds",
            "cost_analysis", "memory_analysis", "parsed", "model_flops"}
REF_PARSED = {"flops_per_chip", "traffic_bytes_per_chip",
              "collective_bytes_per_chip", "num_collectives"}

SMOKE_SHAPES = (ShapeConfig("train_s", 64, 4, "train"),
                ShapeConfig("prefill_s", 64, 2, "prefill"),
                ShapeConfig("decode_s", 64, 2, "decode"))


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without the 512 host devices it
    asks of XLA for the production meshes: the environment variable it
    sets is put back before any JAX backend starts in this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _leaf_bytes(tree):
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_leaf_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b", "zamba2-7b"])
def test_smoke_cells_lower_on_meta(arch):
    cfg = registry.get_smoke_config(arch)
    meta = LMModel(cfg, device="meta")
    for shape in SMOKE_SHAPES:
        art = dryrun.lower_cell(arch, shape, cfg=cfg, microbatches=2)
        assert REF_KEYS <= set(art) and set(art["parsed"]) == REF_PARSED
        assert (art["mesh"], art["chips"], art["cost_analysis"]) == \
            ("1x1", 1, {})
        assert art["kind"] == shape.kind and art["shape"] == shape.name
        mem = art["memory_analysis"]
        params = meta.init()
        batch = dryrun.input_specs(cfg, shape)
        want = _leaf_bytes(params) + _leaf_bytes(batch)
        if shape.kind == "train":
            want += _leaf_bytes(adamw.init(params,
                                           dryrun.optimizer_config(cfg)))
        if shape.kind == "decode":
            want += (_leaf_bytes(meta.init_cache(2, 64))
                     + 2 * 4)                          # cache_index
        assert mem["argument_size_in_bytes"] == want
        assert mem["temp_size_in_bytes"] > 0
        assert mem["output_size_in_bytes"] > 0
        assert art["fits"]["fits"] and art["fits"]["bytes"] == \
            want + mem["temp_size_in_bytes"]
        assert art["parsed"]["flops_per_chip"] > 0
        assert art["parsed"]["collective_bytes_per_chip"] == {}
        assert art["roofline"]["dominant"] in ("compute", "memory")
        assert art["kernel_launches"] == {}          # shipped impls
        if shape.kind == "train":
            assert art["microbatches"] == 2


def test_inputs_microbatches_and_diet_equal_the_reference():
    import jax.numpy as jnp

    from repro.analysis import param_counts
    from repro.configs import shapes_for_arch
    from repro.configs.registry import get_config

    ref = _reference_dryrun()
    for arch in registry.ARCH_NAMES:
        assert dryrun.microbatches_for(arch) == ref.microbatches_for(arch)
        ref_cfg, cfg = get_config(arch), registry.get_config(arch)
        for shape in shapes_for_arch(arch):
            want = ref.input_specs(ref_cfg, shape)
            got = dryrun.input_specs(cfg, shape)
            assert set(got) == set(want)
            for k, spec in want.items():
                assert tuple(got[k].shape) == spec.shape
                assert str(got[k].dtype).split(".")[-1] == \
                    jnp.dtype(spec.dtype).name
                assert got[k].device.type == "meta"
        big = param_counts(ref_cfg)["total"] > 2e10
        opt = dryrun.optimizer_config(cfg)
        assert (opt.factored_second_moment, opt.momentum_dtype,
                opt.accum_dtype) == (
            big, "bfloat16" if big else "float32",
            "bfloat16" if big else "float32")


def test_main_writes_one_cells_artifact(tmp_path, monkeypatch):
    smoke = registry.get_smoke_config("qwen3-14b")
    monkeypatch.setattr(dryrun, "get_config", lambda arch: smoke)
    monkeypatch.setattr(dryrun, "shapes_for_arch",
                        lambda arch: (dataclasses.replace(
                            SMOKE_SHAPES[2], name="decode_32k"),))
    dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    art = json.loads((tmp_path / "qwen3-14b__decode_32k.json").read_text())
    assert art["arch"] == "qwen3-14b" and art["kind"] == "decode"
    assert art["memory_analysis"]["argument_size_in_bytes"] > 0
    assert art["roofline"]["bound_time_s"] > 0


def test_all_cells_are_the_shape_matrix():
    want = list(_reference_dryrun().all_cells())
    got = list(dryrun.all_cells())
    assert sorted(got) == sorted(want) and len(got) == 33
