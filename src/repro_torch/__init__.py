"""PyTorch/CUDA port of the Energon serving stack (``repro``).

The layout mirrors ``repro``: ``core`` (quantization, MP-MRF selection,
attention dispatch, the §IV-D performance model), ``kernels``
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version), ``models``, ``configs``, ``runtime``, ``analysis`` (parameter
and FLOP counts, traffic models, the roofline, the op-cost walk) and
``launch``. The package imports neither ``jax`` nor
``repro``; only the tests import both, to hold the two against each
other on the same numpy inputs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).
"""
