"""PyTorch/CUDA port of the Energon serving stack (``repro``).

The layout mirrors ``repro``: ``core`` (quantization, MP-MRF selection,
attention dispatch), ``kernels`` (hand-written CUDA kernels for Hopper,
each beside its plain PyTorch version), ``models``, ``configs``,
``runtime`` and ``launch``. The package imports neither ``jax`` nor
``repro``; only the tests import both, to hold the two against each
other on the same numpy inputs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).
"""
