"""Grouped (expert) matrix product on the card: the wrapper around the
``gmm_fwd`` entry of ``csrc/matmul.cu`` (the port of the Pallas kernel
``repro/kernels/moe_gmm.py::gmm``).

``(e, c, k) @ (e, k, n) -> (e, c, n)`` on capacity-padded MoE dispatch
buffers: each expert's product with f32 accumulation, rounded once to the
operands' dtype.  It shares the matmul kernels and their three designs
(``matmul.design``: ``"wgmma"`` for bfloat16 and ``"ffma"`` for float32
operands that the rule of ``_tma`` takes, the expert strides included;
``"template"`` for the rest) with one more grid axis over experts.  Any
shape (ragged edges are masked, so an expert-sharded local block need not
divide the tiles) and any element
strides: the weights arrive as per-unit views of the stacked layer
parameters and are read in place.  The wrapper checks what the kernel
takes, allocates the output, launches on PyTorch's current stream and
raises if the launch was refused.  It never falls back: a CPU tensor is an
error here (``kernels/ops.py`` routes CPU tensors to the plain version).

``gmm.launches`` counts successful launches and ``gmm.designs`` splits
them by design.  The launch is the operator ``repro_torch::gmm`` (see
:func:`gmm`), which abstract tensors pass through; ``gmm.fake_designs`` counts
those calls apart.

Gradients: :func:`grouped` is what ``kernels/ops.py`` calls.  Where grad
mode is on and an operand requires grad it goes through :class:`GroupedMatMul`,
whose forward launches the kernel and whose backward pulls the cotangent
back through the plain version; otherwise it launches the kernel and
saves nothing.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _tma, ref
from repro_torch.kernels.matmul import _RULED, layouts

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    built = _build.build("matmul")
    fn = built.lib.gmm_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.matmul_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        wg = built.lib.gmm_wgmma_fwd
        wg.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        wg.restype = ctypes.c_int
        ff = built.lib.gmm_ffma_fwd
        ff.argtypes = wg.argtypes
        ff.restype = ctypes.c_int
    return built.lib


def build_info() -> _build.BuiltKernel:
    """Build (or load) the kernel library; its nvcc log and build time."""
    _lib()
    return _build.build("matmul")


def check_args(x, w) -> None:
    """Raise on ranks, dtypes and shapes the kernel does not take."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"gmm kernel: operands must be 3-d, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise ValueError(
            "gmm kernel: x and w must share one dtype of "
            f"{sorted(str(d) for d in _DTYPES)}, got {x.dtype}, {w.dtype}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"gmm kernel: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain per expert")
    if x.shape[0] > 65535:
        raise ValueError(f"gmm kernel: {x.shape[0]} experts exceed the "
                         "grid's 65535")


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (e, c, k) @ w (e, k, n) for CUDA tensors -> (e, c, n) in x's
    dtype.

    One call of the operator ``repro_torch::gmm``: on real tensors it
    launches the kernel (:func:`launch`); on abstract ones (meta tensors,
    the dry run's blocks, which stand for blocks on a card, and a
    ``FakeTensorMode``'s) it gives the output's shape, dtype and device
    and counts the call by design in ``gmm.fake_designs``, building
    nothing.  Its FLOP formula is 2 e c k n."""
    return _OP(x, w)


#: what the op's abstract implementation takes: a meta tensor stands for
#: one on a card
_ABSTRACT_OK = ("cuda", "meta")


def _check(x, w, devices=("cuda",)) -> None:
    """Raise unless x and w lie on one device of ``devices`` and
    :func:`check_args` takes them."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type not in devices:
            raise ValueError(f"gmm kernel: {name} lies on {t.device}; "
                             "the kernel takes CUDA tensors only")
    if x.device != w.device:
        raise ValueError("gmm kernel: x and w on different devices")
    check_args(x, w)


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The operator's implementation on real tensors: check, allocate the
    output, launch (``chip_smoke.py`` times a call of it beside a call of
    the operator)."""
    _check(x, w)
    (e, c, k), n = x.shape, w.shape[2]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if e == 0 or c == 0 or n == 0:
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
            err = lib.gmm_fwd(*ptrs, _DTYPES[x.dtype], e, c, n, k, *strides, stream)
        else:
            entry = lib.gmm_wgmma_fwd if which == "wgmma" else lib.gmm_ffma_fwd
            err = entry(*ptrs, e, c, n, k, *strides, *lay, stream)
    if err != 0:
        msg = lib.matmul_error_string(err).decode()
        raise RuntimeError(f"gmm kernel ({which}) launch failed: {msg} "
                           f"(cudaError {err}) at {tuple(x.shape)} @ "
                           f"{tuple(w.shape)}, {x.dtype}")
    gmm.launches += 1
    gmm.designs[which] += 1
    return out


def _abstract(x, w):
    _check(x, w, devices=_ABSTRACT_OK)
    (e, c, k), n = x.shape, w.shape[2]
    if e and c and n and k:
        which = "template" if layouts(x, w) is None else _RULED[x.dtype]
        gmm.fake_designs[which] += 1
    return x.new_empty((e, c, n))


_OP = _build.define_op("gmm(Tensor x, Tensor w) -> Tensor", launch, _abstract)


@register_flop_formula(torch.ops.repro_torch.gmm)
def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    e, c, k = x_shape
    return 2 * e * c * k * w_shape[2]


gmm.launches = 0
gmm.designs = dict.fromkeys(_tma.DESIGNS, 0)
gmm.fake_designs = dict.fromkeys(_tma.DESIGNS, 0)


class GroupedMatMul(torch.autograd.Function):
    """The gmm kernel with a backward.  ``forward`` launches the kernel
    (:func:`gmm`) and saves x and w; ``backward`` pulls the cotangent back
    through the plain version (``ref.gmm``).  This mirrors the reference,
    whose auto VJP differentiates the dense reference on purpose
    (``repro/core/opdef.py::_vjp_impl``): the JAX package has no backward
    kernel either."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        return ref.vjp(ref.gmm, ctx.saved_tensors, ctx.needs_input_grad, dy)


def grouped(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`gmm`, through :class:`GroupedMatMul` where grad mode is on
    and x or w requires grad (the only case that saves anything)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatMul.apply(x, w)
    return gmm(x, w)
