"""PyTorch + CUDA port of :mod:`repro` for an NVIDIA H100.

Imports only ``torch`` and ``numpy``. The JAX package ``repro`` is the
reference the tests hold this package to; nothing here imports it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).
"""
