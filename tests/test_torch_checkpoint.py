"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint``, on the CPU.

The layout is the reference's: ``step_XXXXXXXX/arrays.npz`` with the
``/``-joined leaf names, and ``manifest.json`` with the sampled fnv1a
digest. Checked: the atomic write (no ``.tmp-`` directory left, a stale
one ignored), a corrupt newest checkpoint skipped, ``retain``, a bf16
round trip bit for bit (stored as uint16 bits, named in the manifest),
a byte the sampled digest does not read failing the member's CRC-32 on
restore (as ``np.load`` fails it in the reference),
the restore in place into the template's tensors, the async writer
saving what the tree held when ``save`` returned, and the crossing of
f32 checkpoints between the packages — the port restores what the
reference wrote and the reference restores what the port wrote, every
value equal."""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    list_checkpoints,
    restore_latest,
    retain,
    save_checkpoint,
    step_dir,
)
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.optim import adamw


def _tree(seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": {"table": torch.randn(5, 3, generator=gen)},
              "blocks": {"w": torch.randn(2, 3, 4, generator=gen)},
              "norm": torch.randn(3, generator=gen)}
    params = {k: jax.tree.map(lambda a: a.to(dtype), v)
              for k, v in params.items()}
    state = adamw.init(params, adamw.AdamWConfig())
    state = state._replace(
        step=torch.tensor(7, dtype=torch.int32),
        mu=jax.tree.map(lambda a: torch.randn(a.shape, generator=gen),
                        state.mu))
    return {"params": params, "opt": state,
            "data": {"step": torch.tensor(3, dtype=torch.int32)}}


def _assert_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_layout_names_and_atomic_write(tmp_path):
    base = str(tmp_path)
    tree = _tree()
    path = save_checkpoint(base, 12, tree, extra={"model": "m"})
    assert path == step_dir(base, 12) == os.path.join(base, "step_00000012")
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    assert not [d for d in os.listdir(base) if ".tmp-" in d]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert set(z.files) == {
            "params/embed/table", "params/blocks/w", "params/norm",
            "opt/step", "opt/mu/embed/table", "opt/mu/blocks/w",
            "opt/mu/norm", "opt/nu/embed/table", "opt/nu/blocks/w",
            "opt/nu/norm", "data/step"}
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    with open(os.path.join(path, "arrays.npz"), "rb") as f:
        assert manifest["digest"] == jck._fnv1a(f.read())
    assert manifest["step"] == 12 and manifest["num_arrays"] == 11
    assert manifest["model"] == "m" and "bfloat16" not in manifest
    # a crash mid-write leaves a .tmp- directory, which nothing lists
    os.makedirs(step_dir(base, 13) + ".tmp-1-2")
    assert list_checkpoints(base) == [(12, path)]
    step, restored, _ = restore_latest(base, _tree(seed=1))
    assert step == 12
    _assert_equal(restored, tree)


def test_a_corrupt_newest_checkpoint_is_skipped(tmp_path):
    base = str(tmp_path)
    save_checkpoint(base, 1, _tree(seed=1))
    save_checkpoint(base, 2, _tree(seed=2))
    npz = os.path.join(step_dir(base, 2), "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    step, restored, _ = restore_latest(base, _tree(seed=3))
    assert step == 1
    _assert_equal(restored, _tree(seed=1))
    os.remove(os.path.join(step_dir(base, 1), "manifest.json"))
    assert restore_latest(base, _tree()) is None
    assert restore_latest(str(tmp_path / "absent"), _tree()) is None


def test_a_byte_the_digest_skips_fails_the_crc_as_in_the_reference(tmp_path):
    """The sampled digest reads every (size // 65536)-th byte; a flipped
    byte between two samples passes it, and the restore then fails the
    member's CRC-32, in the port as in ``np.load``."""
    base = str(tmp_path)
    tree = {"x": torch.arange(200_000, dtype=torch.float32)}
    save_checkpoint(base, 1, tree)
    npz = os.path.join(step_dir(base, 1), "arrays.npz")
    size = os.path.getsize(npz)
    step = size // 65536
    at = size // 2 + 1
    assert step > 1 and at % step
    with open(npz, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert ck._is_valid(step_dir(base, 1))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        restore_latest(base, {"x": torch.zeros(200_000)})
    with pytest.raises(zipfile.BadZipFile):
        jck.restore_latest(base, {"x": jnp.zeros(200_000)})


def test_retain_keeps_the_newest_and_every_kth(tmp_path):
    base = str(tmp_path)
    tree = {"x": torch.zeros(2)}
    for s in range(1, 8):
        save_checkpoint(base, s, tree)
    retain(base, keep_last=2, keep_every=3)
    assert [s for s, _ in list_checkpoints(base)] == [3, 6, 7]
    retain(base, keep_last=1)
    assert [s for s, _ in list_checkpoints(base)] == [7]


def test_bf16_round_trip_in_place(tmp_path):
    base = str(tmp_path)
    tree = _tree(dtype=torch.bfloat16)
    save_checkpoint(base, 4, tree)
    manifest = json.load(open(os.path.join(step_dir(base, 4),
                                           "manifest.json")))
    assert sorted(manifest["bfloat16"]) == [
        "params/blocks/w", "params/embed/table", "params/norm"]
    template = _tree(seed=9, dtype=torch.bfloat16)
    leaves = jax.tree.leaves(template)
    step, restored, _ = restore_latest(base, template)
    assert step == 4
    _assert_equal(restored, tree)
    # the template's tensors received the arrays in place
    assert all(a is b for a, b in zip(jax.tree.leaves(restored), leaves))
    # a template of another dtype gets new tensors of the stored dtype
    _, other, _ = restore_latest(base, _tree(dtype=torch.float32))
    assert other["params"]["norm"].dtype == torch.bfloat16
    bad = _tree()
    bad["params"]["norm"] = torch.zeros(4)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_latest(base, bad)
    bad = _tree()
    bad["params"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="params/extra"):
        restore_latest(base, bad)


def test_async_saves_what_the_tree_held(tmp_path):
    base = str(tmp_path)
    ckpt = AsyncCheckpointer(base, keep_last=2)
    tree = _tree()
    saved = jax.tree.map(torch.clone, tree)
    for s in (1, 2, 3):
        ckpt.save(s, tree)
        # the next step's in-place update must not reach the write
        jax.tree.map(lambda a: a.add_(1), tree)
    ckpt.wait()
    assert [s for s, _ in list_checkpoints(base)] == [2, 3]
    _, restored, _ = restore_latest(str(base), _tree(seed=5))
    _assert_equal(restored, jax.tree.map(lambda a: a.add_(1).add_(1), saved))


def test_async_wait_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    ckpt = AsyncCheckpointer(str(blocker / "sub"))
    ckpt.save(1, {"x": torch.zeros(1)})
    with pytest.raises(OSError):
        ckpt.wait()
    ckpt.wait()                  # reported once


def _jax_tree(tree):
    """The port's tree as the reference's: numpy → jnp, the state as the
    reference's ``AdamWState``."""
    to = lambda a: jnp.asarray(a.numpy())
    opt = tree["opt"]
    return {"params": jax.tree.map(to, tree["params"]),
            "opt": jadamw.AdamWState(
                step=to(opt.step), mu=jax.tree.map(to, opt.mu),
                nu=jax.tree.map(to, opt.nu)),
            "data": {"step": to(tree["data"]["step"])}}


def test_f32_checkpoints_cross_between_the_packages(tmp_path):
    tree = _tree()
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_checkpoint(ref_dir, 5, _jax_tree(tree))
    step, restored, _ = restore_latest(ref_dir, _tree(seed=4))
    assert step == 5
    _assert_equal(restored, tree)
    save_checkpoint(port_dir, 6, tree)
    step, jrestored, _ = jck.restore_latest(port_dir,
                                            _jax_tree(_tree(seed=4)))
    assert step == 6
    expect = _jax_tree(tree)
    assert jax.tree.structure(jrestored) == jax.tree.structure(expect)
    for a, b in zip(jax.tree.leaves(jrestored), jax.tree.leaves(expect)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_digest_reads_the_reference_sample(tmp_path):
    for size in (0, 1, 1000, 65536 * 3 + 7):
        path = tmp_path / f"f{size}"
        data = np.random.default_rng(size).integers(
            0, 256, size=size, dtype=np.uint8).tobytes()
        path.write_bytes(data)
        assert ck._file_digest(str(path)) == jck._fnv1a(data)
