"""Modality-frontend stubs for the vlm / audio backbones (port of
``repro.models.multimodal``).

The ``[vlm]`` / ``[audio]`` configs specify the transformer backbone
only; the modality frontend (LLaVA-NeXT's anyres vision tower and
projector, MusicGen's EnCodec) is a stub whose contract is what the
backbone's ``embeddings`` input needs: precomputed patch / frame
embeddings of shape ``[batch, seq, d_model]``.

The stubs are deterministic in their seed: 0.02 × a standard normal
drawn from a seeded ``torch.Generator`` on an explicit device. The
numbers differ from the reference's ``jax.random`` draws (and between a
CPU and a CUDA generator); tests that compare the two packages pass the
reference stub's array across as numpy instead.
"""

from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device


def _stub(batch: int, seq: int, d_model: int, dtype, seed: int,
          device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, seq, d_model), generator=gen, device=dev,
                    dtype=torch.float32)
    return (0.02 * x).to(dtype)


def vision_patch_embeddings(batch: int, seq: int, d_model: int,
                            dtype=torch.float32, seed: int = 0,
                            device: DeviceLike = None) -> torch.Tensor:
    """LLaVA-NeXT anyres stub: stands in for CLIP-ViT patch features of
    the tiled image grid, already projected to the LM width and
    concatenated with text embeddings."""
    return _stub(batch, seq, d_model, dtype, seed, device)


def audio_frame_embeddings(batch: int, seq: int, d_model: int,
                           dtype=torch.float32, seed: int = 1,
                           device: DeviceLike = None) -> torch.Tensor:
    """MusicGen stub: stands in for the summed EnCodec codebook
    embeddings per frame (delay-pattern interleaving happens upstream)."""
    return _stub(batch, seq, d_model, dtype, seed, device)


def frontend_embeddings(kind: str, batch: int, seq: int, d_model: int,
                        dtype=torch.float32,
                        device: DeviceLike = None) -> torch.Tensor:
    if kind == "vision":
        return vision_patch_embeddings(batch, seq, d_model, dtype,
                                       device=device)
    if kind == "audio":
        return audio_frame_embeddings(batch, seq, d_model, dtype,
                                      device=device)
    raise ValueError(f"unknown frontend {kind}")
