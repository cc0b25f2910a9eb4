"""What every kernel wrapper shares: binding a built library's C functions,
checking the tensors a kernel is given, and launching on PyTorch's current
stream with the launch error checked.

Each C function takes raw pointers, ints and floats, launches its kernels
on the stream it is given and returns ``cudaGetLastError()`` (0 on
success). A tensor the kernel does not take raises here, before the launch:
a CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# dtype codes of csrc/common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_bound: Dict[str, ctypes.CDLL] = {}


def bind(source: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``source`` (built at first use) with each function's
    argument types set; every function returns an int error code."""
    if source not in _bound:
        lib = build.load(source)
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _bound[source] = lib
    return _bound[source]


def call(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: cudaError {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (the plans size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(name: str, t: Tensor) -> int:
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return DTYPES[t.dtype]


def check(name: str, t: Tensor, shape: Tuple[int, ...], device: torch.device,
          dtype: Optional[torch.dtype] = None) -> None:
    """Device, shape, contiguity and (when given) dtype of a kernel operand."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_index(name: str, n: int) -> None:
    """The kernels index elements with 64-bit offsets but rows, heads and
    columns with 32-bit ints."""
    if n >= 2 ** 31:
        raise ValueError(f"{name}={n} exceeds the kernels' 32-bit indexing")


def aligned(*ts: Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
