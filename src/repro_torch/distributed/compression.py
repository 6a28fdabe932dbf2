"""Error-feedback int8 gradient compression for the DP all-reduce (port
of ``repro.distributed.compression``).

Quantize (grad + error carryover) per tensor to int8, synchronize the
compressed values (an all-gather of int8 codes and one f32 scale per
device, then a local f32 sum — 4× less wire traffic than an f32
all-reduce), and carry the quantization residual into the next step so
the compression bias telescopes away.

:func:`compress` / :func:`decompress` are the pure functions;
:func:`compressed_psum` sums the data rows' gradient trees (one tree per
row of the mesh's data axis, in row order), and
:func:`compressed_psum_shard_map` is the reference's replicated-input
form over the port's :class:`~repro_torch.launch.mesh.Mesh`.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

INT8_MAX = 127.0


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, error) → (int8 codes, scale, new error)."""
    corrected = g.float() + err
    scale = torch.clamp(corrected.abs().max(), min=1e-12) / INT8_MAX
    codes = torch.clamp(torch.round(corrected / scale), -INT8_MAX,
                        INT8_MAX).to(torch.int8)
    new_err = corrected - codes.float() * scale
    return codes, scale, new_err


def decompress(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def _flatten(tree) -> Tuple[List[Any], Any]:
    """A dict / tuple / list tree's leaves and a function that builds the
    same structure from a list of as many leaves."""
    if isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
        keys = list(tree)
    elif isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        keys = None
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def build(leaves):
        out, at = [], 0
        for (_, b), n in zip(parts, sizes):
            out.append(b(leaves[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for p in parts for x in p[0]], build


def init_error_state(params: Any) -> Any:
    leaves, build = _flatten(params)
    return build([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in leaves])


def compressed_psum(grads_rows: Sequence[Any], err_rows: Sequence[Any]
                    ) -> Tuple[List[Any], List[Any]]:
    """Sum the data rows' gradients with int8 error feedback: row r
    compresses ``grads_rows[r] + err_rows[r]`` leaf by leaf; every row
    receives the codes and scales of all rows and sums ``codes · scale``
    in f32 in row order on its own device. Returns (each row's summed
    tree, each row's new error tree)."""
    flat = [_flatten(g) for g in grads_rows]
    errs = [_flatten(e)[0] for e in err_rows]
    packed = [[compress(g, e) for g, e in zip(flat[r][0], errs[r])]
              for r in range(len(flat))]
    sums, new_errs = [], []
    for r, (leaves, build) in enumerate(flat):
        out = []
        for i, g in enumerate(leaves):
            acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for row in packed:
                codes, scale, _ = row[i]
                acc = acc + decompress(codes.to(g.device), scale.to(g.device))
            out.append(acc)
        sums.append(build(out))
        new_errs.append(build([p[2] for p in packed[r]]))
    return sums, new_errs


def compressed_psum_shard_map(grads: Any, err_state: Any, mesh,
                              axis_names=("data",)) -> Tuple[Any, Any]:
    """The reference's ``compressed_psum_shard_map`` over replicated
    grads: every device along ``axis_names`` holds ``grads`` and
    ``err_state``, so the sum is over that many identical compressed
    copies. Returns (summed grads, new error state)."""
    n = 1
    for a in axis_names:
        n *= mesh.shape[a]
    sums, errs = compressed_psum([grads] * n, [err_state] * n)
    return sums[0], errs[0]
