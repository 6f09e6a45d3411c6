"""Tiled matrix product on the card: the wrapper around ``csrc/matmul.cu``
(the port of the Pallas kernel ``repro/kernels/matmul.py::matmul``).

``(m, k) @ (k, n)`` with f32 accumulation, the result in the operands'
dtype: true f32 FMAs for float32, tensor cores (wmma, f32 accumulators) for
bfloat16.  Any shape (ragged edges are masked) and any element strides:
transposed or sliced 2-d views are read as they are, without a copy.  The
wrapper checks what the kernel takes, allocates the output, launches on
PyTorch's current stream and raises if the launch was refused.  It never
falls back: a CPU tensor is an error here (``kernels/ops.py`` routes CPU
tensors to the plain version before they reach this module).

``matmul.launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    built = _build.build("matmul")
    fn = built.lib.matmul_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.matmul_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def build_info() -> _build.BuiltKernel:
    """Build (or load) the kernel library; its nvcc log and build time."""
    _lib()
    return _build.build("matmul")


def check_args(x, w) -> None:
    """Raise on ranks, dtypes and shapes the kernel does not take."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"matmul kernel: operands must be 2-d, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise ValueError(
            "matmul kernel: x and w must share one dtype of "
            f"{sorted(str(d) for d in _DTYPES)}, got {x.dtype}, {w.dtype}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul kernel: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (m, k) @ w (k, n) for CUDA tensors -> (m, n) in x's dtype."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"matmul kernel: {name} lies on {t.device}; "
                             "the kernel takes CUDA tensors only")
    if x.device != w.device:
        raise ValueError("matmul kernel: x and w on different devices")
    check_args(x, w)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.matmul_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             _DTYPES[x.dtype], m, n, k, *x.stride(),
                             *w.stride(), *out.stride(), stream)
    if err != 0:
        msg = lib.matmul_error_string(err).decode()
        raise RuntimeError(f"matmul kernel launch failed: {msg} (cudaError "
                           f"{err}) at {tuple(x.shape)} @ {tuple(w.shape)}, "
                           f"{x.dtype}")
    matmul.launches += 1
    return out


matmul.launches = 0
