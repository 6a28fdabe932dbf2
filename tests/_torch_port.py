"""Helpers shared by the ``test_torch_*`` files: build the reference
(JAX) twin of a port config, move numpy data into both packages, and
make the paged and contiguous dense decode on the same rows. The
reference is imported where it is used: ``test_torch_cuda.py`` imports
this module on a host without JAX."""

import dataclasses

import numpy as np
import torch

# The suite runs in several worker processes beside timing-sensitive JAX
# tests; the port's tests are small, so cap torch's intra-op threads
# rather than let each worker fan out over every core.
torch.set_num_threads(2)


def jax_energon(cfg):
    from repro.core import EnergonConfig as JaxEnergonConfig

    return JaxEnergonConfig(**dataclasses.asdict(cfg))


def jax_model_config(cfg):
    from repro.configs.base import ModelConfig as JaxModelConfig

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["energon"] = jax_energon(cfg.energon)
    return JaxModelConfig(**fields)


def t(x, dtype=None) -> torch.Tensor:
    """numpy (or jax) array → CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor or jax array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dense_decode_twins(device, batch=3, heads=2, g=3, d=16, ps=8, mb=4,
                        seed=4):
    """The dense (prefix-layer) decode of the paged path and of the
    contiguous path on the same rows: the pool's pages under a shuffled
    table, and the contiguous cache they spell. Returns the two outputs,
    the paged pool's logical rows and the contiguous keys."""
    from repro_torch.configs.registry import get_serve_config
    from repro_torch.core.energon_attention import (
        energon_decode_attention, energon_paged_decode_attention,
    )
    from repro_torch.runtime import paged_cache as pgc

    cfg = get_serve_config("qwen3-14b", smoke=True).energon
    cfg = dataclasses.replace(cfg, decode_key_block=ps)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_k = mb * ps
    k, v = (torch.randn((batch, heads, n_k, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    table = torch.randperm(batch * mb, generator=gen, device=device).reshape(
        batch, mb).to(torch.int32)
    inv = torch.empty(batch * mb, dtype=torch.long, device=device)
    inv[table.reshape(-1).long()] = torch.arange(batch * mb, device=device)

    def pool(x):                     # [B, KV, n_k, d] → [KV, pool rows, d]
        x = x.reshape(batch, heads, mb, ps, d).movedim(1, 0)
        return x.reshape(heads, batch * mb, ps, d)[:, inv].reshape(
            heads, -1, d)

    q = torch.randn((batch, heads, g, d), generator=gen, device=device).to(
        torch.bfloat16)
    cl = torch.randint(1, n_k + 1, (batch,), generator=gen,
                       device=device).to(torch.int32)
    paged = energon_paged_decode_attention(
        q, {"k": pool(k), "v": pool(v)}, table, cl, cfg, layer_index=0)
    unpaged = energon_decode_attention(q, k, v, cl, cfg, layer_index=0)
    return paged, unpaged, pgc.gather_logical_rows(pool(k), table, ps), k
