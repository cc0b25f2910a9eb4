"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Nothing here builds or loads a kernel at import time: the first CUDA call
of a wrapper builds ``csrc/`` with nvcc (:mod:`repro_torch.kernels.build`).
"""
