"""Helpers shared by the ``test_torch_*`` files: build the reference
(JAX) twin of a port config, and move numpy data into both packages."""

import dataclasses

import numpy as np
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import EnergonConfig as JaxEnergonConfig

# The suite runs in several worker processes beside timing-sensitive JAX
# tests; the port's tests are small, so cap torch's intra-op threads
# rather than let each worker fan out over every core.
torch.set_num_threads(2)


def jax_energon(cfg) -> JaxEnergonConfig:
    return JaxEnergonConfig(**dataclasses.asdict(cfg))


def jax_model_config(cfg) -> JaxModelConfig:
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
