"""Dense attention (port of ``repro.core.sparse_attention.dense_attention``).

The path the unpruned prefix layers (below ``min_prune_layer``) take over
the logical view of the page pool. The block-gather XLA paths of the
reference wait for a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled-dot-product attention with f32 scores and softmax.

    q ``[..., n_q, d]``, k/v ``[..., n_k, d]``; ``valid`` a bool mask
    broadcastable to ``[..., n_q, n_k]``. Output in ``v``'s dtype.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)
