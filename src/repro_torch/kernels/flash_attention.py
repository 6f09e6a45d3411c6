"""Forward flash attention on the card: the wrapper around
``csrc/flash_attention.cu`` (the port of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``).

The kernel computes exactly what ``kernels/ref.attention`` computes — f32
online-softmax state, absolute-position causal / sliding-window masks,
fully masked KV tiles skipped, GQA — for float32 and bfloat16 inputs with
head_dim <= 256 and any sequence lengths.  The wrapper checks what the
kernel takes, allocates the output, launches on PyTorch's current stream
and raises if the launch was refused.  It never falls back: a CPU tensor is
an error here (the dispatcher in ``kernels/ops.py`` routes CPU tensors to
the plain version before they reach this module).

``flash_attention.launches`` counts successful launches, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _lib():
    built = _build.build("flash_attention")
    fn = built.lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.flash_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def build_info() -> _build.BuiltKernel:
    """Build (or load) the kernel library; its nvcc log and build time."""
    _lib()
    return _build.build("flash_attention")


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} lies on "
                             f"{t.device}; the kernel takes CUDA tensors only")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel: q, k, v on different devices")
    check_args(q, k, v)


def check_args(q, k, v) -> None:
    """Raise on ranks, dtypes and shapes the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-d "
                             f"(b, h, s, d), got shape {tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(
            "flash_attention kernel: q, k, v must share one dtype of "
            f"{sorted(str(d) for d in _DTYPES)}, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention kernel: GQA needs hq % hkv == 0, "
                         f"got hq={hq}, hkv={hkv}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head_dim {d} > "
                         f"{MAX_HEAD_DIM} is not supported")
    if sk == 0:
        raise ValueError("flash_attention kernel: no keys (sk == 0)")


def _last_dim_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(3) == 1 else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    kv_offset: int = 0) -> torch.Tensor:
    """q (b, hq, sq, d), k/v (b, hkv, sk, d) CUDA tensors -> (b, hq, sq, d)
    in q's dtype.  Any strides whose last dim is contiguous are taken as
    they are (the model's (b, s, h, d) projections arrive transposed)."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if sq == 0:
        return o
    q, k, v = (_last_dim_contiguous(t) for t in (q, k, v))
    scale = (d ** -0.5) if scale is None else float(scale)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            scale, int(bool(causal)), int(window), int(q_offset),
            int(kv_offset), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"(cudaError {err}) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
