"""Tiled matrix product on the card: the wrapper around ``csrc/matmul.cu``
(the port of the Pallas kernel ``repro/kernels/matmul.py::matmul``).

``(m, k) @ (k, n)`` with f32 accumulation, the result in the operands'
dtype.  Three designs, picked before launch by :func:`design` and by
nothing else: ``"wgmma"`` for bfloat16 operands that TMA can address
(tensor cores through wgmma, TMA tile loads, an mbarrier pipeline),
``"ffma"`` for float32 operands under the same rule (true f32 FMAs on the
CUDA cores fed by a cp.async ring) and ``"template"`` for the rest (true
f32 FMAs for float32, wmma tensor cores for bfloat16, operands whose
strides or base the rule refuses).  Any shape (ragged edges are masked)
and, in the template, any element strides; the wgmma and ffma designs read
K-major or M-major x and N-major or K-major w, so transposed 2-d views are
read as they are, without a copy.  The wrapper checks what the
kernel takes, allocates the output, launches on PyTorch's current stream
and raises if the launch was refused.  It never falls back: a CPU tensor is
an error here (``kernels/ops.py`` routes CPU tensors to the plain version
before they reach this module), and a refused launch raises without trying
the other design.

``matmul.launches`` counts successful launches and ``matmul.designs``
splits them by design.  The launch is the operator ``repro_torch::matmul``
(see :func:`matmul`), which abstract tensors pass through;
``matmul.fake_designs`` counts those calls apart.

Gradients: :func:`product` is what ``kernels/ops.py`` calls.  Where grad
mode is on and an operand requires grad it goes through :class:`MatMul`,
whose forward launches the kernel and whose backward pulls the cotangent
back through the plain version; otherwise it launches the kernel and
saves nothing.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _tma, ref

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
        wg = built.lib.matmul_wgmma_fwd
        wg.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        wg.restype = ctypes.c_int
        ff = built.lib.matmul_ffma_fwd
        ff.argtypes = wg.argtypes
        ff.restype = ctypes.c_int
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


_RULED = {torch.bfloat16: "wgmma", torch.float32: "ffma"}


def layouts(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int] | None:
    """``(x_mn, w_mn)`` for the wgmma (bfloat16) or ffma (float32) design —
    x_mn = 1 where x is read M-major (its row dim contiguous) rather than
    K-major, w_mn = 1 where w is read N-major rather than K-major — or None
    where x or w cannot be addressed either way (a contiguous inner dim,
    every other stride and the base 16-byte multiples: ``_tma``) or the
    dtypes are neither.  The last two dims are the product's; any dims
    before them (experts) ride along."""
    if x.dtype != w.dtype or x.dtype not in _RULED:
        return None
    r = x.dim() - 1  # x (..., m, k), w (..., k, n)
    x_mn = (0 if _tma.tensor_addressable(x, inner=r) else
            1 if _tma.tensor_addressable(x, inner=r - 1) else None)
    w_mn = (1 if _tma.tensor_addressable(w, inner=r) else
            0 if _tma.tensor_addressable(w, inner=r - 1) else None)
    if x_mn is None or w_mn is None:
        return None
    return x_mn, w_mn


def design(x: torch.Tensor, w: torch.Tensor) -> str:
    """The design that serves ``x @ w``: where :func:`layouts` finds one,
    ``"wgmma"`` for bfloat16 and ``"ffma"`` for float32, else
    ``"template"``.  Reads dtypes, shapes, strides and base addresses
    only."""
    return "template" if layouts(x, w) is None else _RULED[x.dtype]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (m, k) @ w (k, n) for CUDA tensors -> (m, n) in x's dtype.

    One call of the operator ``repro_torch::matmul``: on real tensors it
    launches the kernel (:func:`launch`); on abstract ones (meta tensors,
    the dry run's blocks, which stand for blocks on a card, and a
    ``FakeTensorMode``'s) it gives the output's shape, dtype and device
    and counts the call by design in ``matmul.fake_designs``, building
    nothing.  Its FLOP formula is 2 m k n."""
    return _OP(x, w)


#: what the op's abstract implementation takes: a meta tensor stands for
#: one on a card
_ABSTRACT_OK = ("cuda", "meta")


def _check(x, w, devices=("cuda",)) -> None:
    """Raise unless x and w lie on one device of ``devices`` and
    :func:`check_args` takes them."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type not in devices:
            raise ValueError(f"matmul kernel: {name} lies on {t.device}; "
                             "the kernel takes CUDA tensors only")
    if x.device != w.device:
        raise ValueError("matmul kernel: x and w on different devices")
    check_args(x, w)


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The operator's implementation on real tensors: check, allocate the
    output, launch (``chip_smoke.py`` times a call of it beside a call of
    the operator)."""
    _check(x, w)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    lay = layouts(x, w)
    which = "template" if lay is None else _RULED[x.dtype]
    lib = _lib()
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
    strides = (*x.stride(), *w.stride(), *out.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if lay is None:
            err = lib.matmul_fwd(*ptrs, _DTYPES[x.dtype], m, n, k, *strides, stream)
        else:
            entry = lib.matmul_wgmma_fwd if which == "wgmma" else lib.matmul_ffma_fwd
            err = entry(*ptrs, m, n, k, *strides, *lay, stream)
    if err != 0:
        msg = lib.matmul_error_string(err).decode()
        raise RuntimeError(f"matmul kernel ({which}) launch failed: {msg} "
                           f"(cudaError {err}) at {tuple(x.shape)} @ "
                           f"{tuple(w.shape)}, {x.dtype}")
    matmul.launches += 1
    matmul.designs[which] += 1
    return out


def _abstract(x, w):
    _check(x, w, devices=_ABSTRACT_OK)
    (m, k), n = x.shape, w.shape[1]
    if m and n and k:
        matmul.fake_designs[design(x, w)] += 1
    return x.new_empty((m, n))


_OP = _build.define_op("matmul(Tensor x, Tensor w) -> Tensor", launch, _abstract)


@register_flop_formula(torch.ops.repro_torch.matmul)
def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


matmul.launches = 0
matmul.designs = dict.fromkeys(_tma.DESIGNS, 0)
matmul.fake_designs = dict.fromkeys(_tma.DESIGNS, 0)


class MatMul(torch.autograd.Function):
    """The matmul kernel with a backward.  ``forward`` launches the kernel
    (:func:`matmul`) and saves x and w; ``backward`` pulls the cotangent
    back through the plain version (``ref.matmul``).  This mirrors the
    reference, whose auto VJP differentiates the dense reference on purpose
    (``repro/core/opdef.py::_vjp_impl``): the JAX package has no backward
    kernel either."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        return ref.vjp(ref.matmul, ctx.saved_tensors, ctx.needs_input_grad,
                       dy)


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`matmul`, through :class:`MatMul` where grad mode is on and x
    or w requires grad (the only case that saves anything)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MatMul.apply(x, w)
    return matmul(x, w)
