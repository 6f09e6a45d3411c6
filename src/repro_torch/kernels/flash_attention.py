"""Flash attention on the card: the wrappers around
``csrc/flash_attention.cu`` — the forward kernel (the port of the Pallas
kernel ``repro/kernels/flash_attention.py::flash_attention``) and the
ring-attention step kernel (the port of ``flash_attention_step``).

The forward kernel computes what ``kernels/ref.attention_tiled`` computes —
f32 online-softmax state, absolute-position causal / sliding-window masks,
the TPU kernel's 128 x 128 tile skipping, GQA — which equals
``ref.attention`` on every row that sees a key.  It takes float32 and
bfloat16 inputs with head_dim <= 256 and any sequence lengths.  It has
three designs, picked before launch by :func:`design` and by nothing else:
``"wgmma"`` (bf16, head_dim 64, 128 or 256, tensors TMA can address: wgmma,
TMA and an mbarrier pipeline), ``"ffma"`` (float32 at head_dim 64, 128 or
256 under the same rule: cp.async copies and register-tiled f32 FMAs on
the CUDA cores, in 32-row q tiles at 256) and ``"template"`` (everything
else: f32 FMAs on the CUDA cores).  The wrapper checks what the
kernel takes, allocates the output, launches on PyTorch's current stream
and raises if the launch was refused.  It never falls back: a CPU tensor is
an error here (the dispatcher in ``kernels/ops.py`` routes CPU tensors to
the plain version before they reach this module), and a refused launch of
any design raises without trying another.

The step kernel folds one KV block into a carried f32 state ``(m, l,
acc)`` with the finite ``-1e30`` masking of ``kernels/ref.attention_step``
and no tile skipping; it updates the carry it is given in place.  It has
the same three designs under the same rule (:func:`design` with
``step=True``), except that its ``"wgmma"`` and ``"ffma"`` take head_dim 64
and 128 only: ``"wgmma"`` and ``"ffma"`` are those forward kernels with the carry
read into their accumulators and written back, ``"template"`` the
template forward kernel's.

``flash_attention.launches`` and ``flash_attention_step.launches`` count
successful launches, so a run can show that its main path went through
the kernels; ``flash_attention.designs`` and
``flash_attention_step.designs`` split them by design.

The forward is the operator ``repro_torch::flash_attention`` (see
:func:`flash_attention`), so that abstract tensors pass through it: the dry
run (``launch/dryrun.py``) runs a step on them, and
``flash_attention.fake_designs`` counts those calls by design, apart from
the launches.  The ring step stays a plain wrapper: it writes its carry in
place, and no abstract path reaches it.

Gradients: :func:`attention` is what ``kernels/ops.py`` calls.  Where grad
mode is on and an input requires grad it goes through
:class:`FlashAttention`, whose forward launches the kernel and whose
backward pulls the cotangent back through the plain version; otherwise it
launches the kernel and saves nothing.  The step kernel has no backward
and raises under grad rather than return a carry that drops it.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _tma, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128, 256)
WGMMA_STEP_HEAD_DIMS = (64, 128)  # no path runs the step at 256: the template
FFMA_HEAD_DIMS = (64, 128, 256)
FFMA_STEP_HEAD_DIMS = (64, 128)
DESIGNS = _tma.DESIGNS  # ("wgmma", "ffma", "template")


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
        step = built.lib.flash_attention_step
        step.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                         + [ctypes.c_longlong] * 9 + [ctypes.c_float]
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        step.restype = ctypes.c_int
        wg = built.lib.flash_attention_wgmma_fwd
        wg.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        wg.restype = ctypes.c_int
        ws = built.lib.flash_attention_step_wgmma
        ws.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        ws.restype = ctypes.c_int
        built.lib.flash_attention_ffma_fwd.argtypes = wg.argtypes
        built.lib.flash_attention_ffma_fwd.restype = ctypes.c_int
        built.lib.flash_attention_step_ffma.argtypes = ws.argtypes
        built.lib.flash_attention_step_ffma.restype = ctypes.c_int
    return built.lib


def build_info() -> _build.BuiltKernel:
    """Build (or load) the kernel library; its nvcc log and build time."""
    _lib()
    return _build.build("flash_attention")


#: what the op's abstract implementation takes: a meta tensor stands for
#: one on a card
_ABSTRACT_OK = ("cuda", "meta")


def _check(q, k, v, devices=("cuda",)):
    """Raise unless q, k and v lie on one device of ``devices`` and
    :func:`check_args` takes them."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type not in devices:
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


def design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           step: bool = False) -> str:
    """The design that serves (q, k, v), the forward or (``step``) the
    ring step: where all three are addressable (16-byte aligned bases, a
    contiguous head dim, every other stride a positive multiple of 16
    bytes: what TMA and 16-byte cp.async copies take), ``"wgmma"`` for
    bfloat16 and ``"ffma"`` for float32, each with head_dim 64, 128 or 256
    (the step 64 or 128); else ``"template"``.  Reads dtypes, shapes,
    strides and base addresses only."""
    ruled = {torch.bfloat16: ("wgmma", WGMMA_STEP_HEAD_DIMS if step else WGMMA_HEAD_DIMS),
             torch.float32: ("ffma", FFMA_STEP_HEAD_DIMS if step else FFMA_HEAD_DIMS)
             }.get(q.dtype)
    if ruled and q.shape[-1] in ruled[1] and all(
            _tma.tensor_addressable(t, inner=3) for t in (q, k, v)):
        return ruled[0]
    return "template"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    kv_offset: int = 0) -> torch.Tensor:
    """q (b, hq, sq, d), k/v (b, hkv, sk, d) CUDA tensors -> (b, hq, sq, d)
    in q's dtype.  Any strides whose last dim is contiguous are taken as
    they are (the model's (b, s, h, d) projections arrive transposed).

    One call of the operator ``repro_torch::flash_attention``: on real
    tensors it launches the kernel (:func:`launch`); on abstract ones (meta
    tensors, the dry run's blocks, which stand for blocks on a card, and a
    ``FakeTensorMode``'s) it gives the output's shape, dtype and device,
    builds nothing and touches no CUDA API, and counts the call by design
    in ``flash_attention.fake_designs``.  Its FLOP formula for
    ``FlopCounterMode`` is SDPA's convention: 4 b hq sq sk d, the two
    products in full, no discount for the causal or window mask."""
    return _OP(q, k, v, bool(causal), int(window), None if scale is None else float(scale),
               int(q_offset), int(kv_offset))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int, scale: float | None, q_offset: int,
           kv_offset: int) -> torch.Tensor:
    """The operator's implementation on real tensors: check, allocate the
    output, launch (``chip_smoke.py`` times a call of it beside a call of
    the operator)."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if sq == 0:
        return o
    q, k, v = (_last_dim_contiguous(t) for t in (q, k, v))
    scale = (d ** -0.5) if scale is None else float(scale)
    which = design(q, k, v)
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    shape = (b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *o.stride()[:3], scale, int(bool(causal)),
             int(window), int(q_offset), int(kv_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":
            err = lib.flash_attention_wgmma_fwd(*args, *shape, stream)
        elif which == "ffma":
            err = lib.flash_attention_ffma_fwd(*args, *shape, stream)
        else:
            err = lib.flash_attention_fwd(*args, _DTYPES[q.dtype], *shape, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel ({which}) launch failed: "
                           f"{msg} (cudaError {err}) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches += 1
    flash_attention.designs[which] += 1
    return o


def _abstract(q, k, v, causal, window, scale, q_offset, kv_offset):
    _check(q, k, v, devices=_ABSTRACT_OK)
    if q.shape[2]:
        which = design(*(_last_dim_contiguous(t) for t in (q, k, v)))
        flash_attention.fake_designs[which] += 1
    return q.new_empty(q.shape)


_OP = _build.define_op("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
                       "int window, float? scale, int q_offset, int kv_offset) -> Tensor",
                       launch, _abstract)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    b, hq, sq, d = q_shape
    return 4 * b * hq * sq * k_shape[2] * d


flash_attention.launches = 0
flash_attention.designs = dict.fromkeys(DESIGNS, 0)
flash_attention.fake_designs = dict.fromkeys(DESIGNS, 0)


class FlashAttention(torch.autograd.Function):
    """The forward kernel with a backward.  ``forward`` launches the kernel
    (:func:`flash_attention`) and saves q, k and v as they were passed;
    ``backward`` recomputes the plain version (``ref.attention``) from them
    and pulls the cotangent back through it.  This mirrors the reference,
    whose auto VJP differentiates the dense reference on purpose
    (``repro/core/opdef.py::_vjp_impl``): the JAX package has no backward
    kernel either.  Rows that see no key are where the two differ
    (``ref.attention_tiled``); causal and windowed training never has
    them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, kv_offset):
        ctx.kw = dict(causal=causal, window=window, scale=scale,
                      q_offset=q_offset, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, do):
        return (*ref.vjp(lambda q, k, v: ref.attention(q, k, v, **ctx.kw),
                         ctx.saved_tensors, ctx.needs_input_grad, do),
                None, None, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: float | None = None, q_offset: int = 0,
              kv_offset: int = 0) -> torch.Tensor:
    """:func:`flash_attention`, through :class:`FlashAttention` where grad
    mode is on and q, k or v requires grad (the only case that saves
    anything)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale, q_offset,
                                    kv_offset)
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                           q_offset=q_offset, kv_offset=kv_offset)


def flash_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         carry: tuple | None = None, *, causal: bool = True,
                         window: int = 0, scale: float | None = None,
                         q_offset: int = 0, kv_offset: int = 0) -> tuple:
    """Fold the KV block k/v (b, hkv, blk, d) into the carry ``(m, l, acc)``
    of q (b, hq, sq, d) — f32 (b, hq, sq), (b, hq, sq), (b, hq, sq, d) — and
    return it.  A given carry is updated in place (non-contiguous or
    non-f32 parts, and an acc whose base is not 16-byte aligned, are copied
    first and the copies updated); ``None`` starts from ``(-1e30, 0, 0)``.
    ``q_offset`` / ``kv_offset`` are the absolute positions of q[0] and
    k[0].  The design is :func:`design`'s (``step=True``), read from q, k
    and v.

    The carry is updated in place and there is no backward, so with grad
    mode on and an input (q, k, v or the carry) that requires grad this
    raises instead of returning a carry that silently drops the
    gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, *(carry or ()))):
        raise RuntimeError(
            "flash_attention_step kernel: an input requires grad, but the "
            "step updates its carry in place and has no backward; run it "
            "under torch.no_grad(), or differentiate the plain version "
            "(ops.flash_attention_step(..., impl='ref'))")
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    if carry is None:
        m = torch.empty((b, hq, sq), **f32)
        l = torch.empty((b, hq, sq), **f32)
        acc = torch.empty((b, hq, sq, d), **f32)
    else:
        m, l, acc = (t.to(torch.float32).contiguous() for t in carry)
        if acc.data_ptr() % 16:
            acc = acc.clone()
        want = ((b, hq, sq), (b, hq, sq), (b, hq, sq, d))
        if tuple(tuple(t.shape) for t in (m, l, acc)) != want or any(
                t.device != q.device for t in (m, l, acc)):
            raise ValueError(
                f"flash_attention_step kernel: carry shapes "
                f"{[tuple(t.shape) for t in (m, l, acc)]} on "
                f"{[str(t.device) for t in (m, l, acc)]}, want {list(want)} "
                f"on {q.device}")
    if sq == 0:
        return m, l, acc
    q, k, v = (_last_dim_contiguous(t) for t in (q, k, v))
    scale = (d ** -0.5) if scale is None else float(scale)
    which = design(q, k, v, step=True)
    lib = _lib()
    carry_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
                  l.data_ptr(), acc.data_ptr(), int(carry is None))
    shape = (b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], scale, int(bool(causal)), int(window),
             int(q_offset), int(kv_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":
            err = lib.flash_attention_step_wgmma(*carry_ptrs, *shape, stream)
        elif which == "ffma":
            err = lib.flash_attention_step_ffma(*carry_ptrs, *shape, stream)
        else:
            err = lib.flash_attention_step(*carry_ptrs, _DTYPES[q.dtype], *shape,
                                           stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_step kernel ({which}) launch failed: "
                           f"{msg} (cudaError {err}) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}")
    flash_attention_step.launches += 1
    flash_attention_step.designs[which] += 1
    return m, l, acc


flash_attention_step.launches = 0
flash_attention_step.designs = dict.fromkeys(DESIGNS, 0)
