"""Fault-tolerant checkpointing (port of
``repro.checkpoint.checkpointer``): atomic, async, the same layout.

Layout::

    <dir>/step_00001200/
        arrays.npz        # flattened param/opt/data-state tree
        manifest.json     # step, digest, array count, time, extras

Array names are the reference's: the tree path ``/``-joined (dict keys,
a NamedTuple's field names; a None subtree has no arrays), and the manifest's digest is the reference's sampled fnv1a of
the ``arrays.npz`` bytes.

Guarantees:
  * atomicity — written to ``.tmp-`` then ``os.rename``d; a crash
    mid-write never corrupts the latest valid checkpoint;
  * integrity — restore skips directories whose digest does not match
    and falls back to the previous step (node-failure recovery);
  * async — `AsyncCheckpointer` copies device→host in the caller's
    thread and writes in a thread, so the loop blocks only for the copy.

numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bits and
named in the manifest's ``"bfloat16"`` list; restore views the bits
back. The reference stores bf16 through ``ml_dtypes``, so checkpoints
cross between the two packages in f32 only. Restore reads one array at
a time into the template's leaves, and the digest reads only the
sampled bytes, so neither holds a whole checkpoint in host memory.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: the manifest key listing the arrays stored as bf16 bits
BF16_KEY = "bfloat16"


def _fnv1a(data) -> int:
    """The reference's sampled fnv1a over a byte buffer (``bytes`` or a
    uint8 array)."""
    h = 0xCBF29CE484222325
    sample = data[:: max(1, len(data) // 65536)]          # sampled digest
    if isinstance(sample, np.ndarray):
        sample = sample.tobytes()
    for b in sample:
        h ^= b
        h = (h * 0x100000001B3) % (2 ** 64)
    return h


def _file_digest(path: str) -> int:
    """:func:`_fnv1a` of a file's bytes, reading only the sampled ones."""
    if os.path.getsize(path) == 0:
        return _fnv1a(b"")
    return _fnv1a(np.memmap(path, dtype=np.uint8, mode="r"))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """A subtree's ``(name, child)`` pairs in the reference's flattening
    order (dict keys sorted, a NamedTuple's fields), or None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    return None


def _named_leaves(tree: Any, prefix: str = ""):
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from _named_leaves(child, f"{prefix}/{name}" if prefix
                                 else name)


def _to_host(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor that no later in-place update can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.as_tensor(np.asarray(leaf))


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, bool]:
    """``(array, stored as bf16 bits)``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _unflatten_like(template: Any, load, prefix: str = "") -> Any:
    """``template``'s structure with each leaf ``load(name, leaf)``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return load(prefix, template)
    name = lambda k: f"{prefix}/{k}" if prefix else k
    if isinstance(template, dict):
        return {k: _unflatten_like(v, load, name(str(k)))
                for k, v in template.items()}
    return type(template)(*(_unflatten_like(c, load, name(k))
                            for k, c in kids))


def step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def _write(base: str, step: int, host: Dict[str, torch.Tensor],
           extra: Optional[Dict]) -> str:
    os.makedirs(base, exist_ok=True)
    final = step_dir(base, step)
    tmp = final + f".tmp-{os.getpid()}-{int(time.time()*1e6)}"
    os.makedirs(tmp, exist_ok=True)
    flat, bf16 = {}, []
    for key, t in host.items():
        flat[key], is_bf16 = _to_numpy(t)
        if is_bf16:
            bf16.append(key)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **flat)
    manifest = {
        "step": step,
        "digest": _file_digest(npz_path),
        "num_arrays": len(flat),
        "time": time.time(),
        **({BF16_KEY: bf16} if bf16 else {}),
        **(extra or {}),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(
    base: str, step: int, tree: Any, extra: Optional[Dict] = None
) -> str:
    """Atomic synchronous save. Returns the checkpoint directory."""
    return _write(base, step, {k: _to_host(v)
                               for k, v in _named_leaves(tree)}, extra)


def _is_valid(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return (_file_digest(os.path.join(path, "arrays.npz"))
                == manifest["digest"])
    except (OSError, KeyError, ValueError, json.JSONDecodeError):
        return False


def list_checkpoints(base: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        if name.startswith("step_") and ".tmp-" not in name:
            try:
                out.append((int(name[5:]), os.path.join(base, name)))
            except ValueError:
                continue
    return sorted(out)


class _NpzReader:
    """The arrays of an ``np.savez`` file, one at a time. A stored
    (uncompressed) member is read with one ``readinto`` at its offset —
    ``np.load`` reads a zip member in 256 KiB pieces, a minute for a
    checkpoint of tens of GB — and its CRC-32 is checked, as ``np.load``
    checks it. ``np.savez`` stores every member uncompressed."""

    def __init__(self, path: str):
        self._zip = zipfile.ZipFile(path)
        self._file = open(path, "rb")
        self._info = {i.filename[:-4]: i for i in self._zip.infolist()
                      if i.filename.endswith(".npy")}
        self.names = set(self._info)

    def read(self, key: str) -> np.ndarray:
        info = self._info[key]
        if info.compress_type != zipfile.ZIP_STORED:
            raise zipfile.BadZipFile(f"array {key!r} is compressed")
        f = self._file
        f.seek(info.header_offset)
        local = f.read(30)
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0
                       if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        head = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(head))
        arr = np.empty(shape[::-1] if fortran else shape, dtype=dtype)
        view = memoryview(arr.reshape(-1).view(np.uint8))
        if f.readinto(view) != len(view) or head + len(view) != \
                info.file_size:
            raise zipfile.BadZipFile(f"truncated array {key!r}")
        if zlib.crc32(view, crc) != info.CRC:
            raise zipfile.BadZipFile(f"bad CRC-32 for array {key!r}")
        return arr.T if fortran else arr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._file.close()
        self._zip.close()


def restore_latest(
    base: str, template: Any
) -> Optional[Tuple[int, Any, Dict]]:
    """Restore the newest *valid* checkpoint (corrupt ones are skipped —
    this is the node-failure / preemption recovery path) into
    ``template``'s structure. A template tensor of the stored dtype
    receives its array in place, as ``load_state_dict`` does, so a
    restore on the device never holds two copies of the state; another
    leaf becomes a new tensor of the stored dtype on the template leaf's
    device (the CPU for a non-tensor leaf). A missing array or a shape
    mismatch raises, possibly after earlier leaves were written."""
    for step, path in reversed(list_checkpoints(base)):
        if not _is_valid(path):
            continue
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        bf16 = set(manifest.get(BF16_KEY, ()))
        with _NpzReader(os.path.join(path, "arrays.npz")) as z:

            def load(key, leaf):
                if key not in z.names:
                    raise KeyError(f"checkpoint missing array {key!r}")
                arr = z.read(key)
                shape = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                              else np.shape(leaf))
                if tuple(arr.shape) != shape:
                    raise ValueError(
                        f"shape mismatch for {key}: ckpt {arr.shape} vs "
                        f"model {shape}")
                t = torch.from_numpy(arr)
                if key in bf16:
                    t = t.view(torch.int16).view(torch.bfloat16)
                if not isinstance(leaf, torch.Tensor):
                    return t
                if leaf.dtype == t.dtype:     # in place: one copy alive
                    return leaf.copy_(t)
                return t.to(leaf.device)

            tree = _unflatten_like(template, load)
        return step, tree, manifest
    return None


def retain(base: str, keep_last: int = 3, keep_every: int = 0) -> None:
    """Delete old checkpoints, keeping the newest ``keep_last`` and every
    ``keep_every``-th step (0 = none) for post-hoc analysis."""
    ckpts = list_checkpoints(base)
    if len(ckpts) <= keep_last:
        return
    protected = set(s for s, _ in ckpts[-keep_last:])
    if keep_every:
        protected |= {s for s, _ in ckpts if s % keep_every == 0}
    for step, path in ckpts:
        if step not in protected:
            shutil.rmtree(path, ignore_errors=True)


class AsyncCheckpointer:
    """One background writer thread; the loop only pays device→host."""

    def __init__(self, base: str, keep_last: int = 3, keep_every: int = 0):
        self.base = base
        self.keep_last = keep_last
        self.keep_every = keep_every
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        host = {k: _to_host(v) for k, v in _named_leaves(tree)}

        def work():
            try:
                _write(self.base, step, host, extra)
                retain(self.base, self.keep_last, self.keep_every)
            except BaseException as exc:       # re-raised by wait()
                self._error = exc

        with self._lock:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()

    def wait(self):
        """Join the pending write; raise the error it ended with."""
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None:
            raise err
