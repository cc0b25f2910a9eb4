"""Device choice and float32 precision, in one place.

Entry points take ``device=None``, which means the card: with no card they
raise rather than carry on on the CPU. ``device="cpu"`` is the explicit
request for the plain PyTorch path (the tests use it).

TF32 is off for both matrix products and cuDNN convolutions: PyTorch turns
it on for cuDNN by default, and TF32 keeps about three decimal digits, which
the f32 parity bounds against the JAX reference do not allow.

cuDNN takes deterministic convolution algorithms only: with its default
ones two identical ResNet44 runs on an H100 differ after a few steps
(``scripts/vision_determinism.py``), and a resumed run must equal an
uninterrupted one bit for bit.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the first CUDA device (raises without one)."""
    set_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev



def process_index_count() -> Tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1): a single process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
