"""The built-in op catalog: every map and opaque op the stack ships with,
declared through the unified OpDef API (core/opdef.py).

This module is imported lazily on first registry access
(``opdef._ensure_builtins``).  Each entry is one declarative record —
signature, dense reference impl, optional accelerator kernel dispatcher,
VJP rule, comm declaration, shard-rule binding — the same records as the
reference catalog, with torch impls.

Every impl accepts numpy arrays or torch tensors (the dense numpy oracle
calls them with numpy arrays) and returns a torch tensor.  MoE
dispatch/combine and the recurrent scans are *declared* here and carry no
impl: their semantics arrive with the MoE and recurrent slices of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.opdef import defop


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


# ---------------------------------------------------------------------------
# Elementwise map ops (+ their derivative maps, linked via grad=)
# ---------------------------------------------------------------------------


def _softmax(x, dim=-1):
    x = _t(x)
    m = torch.amax(x, dim=dim, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=dim, keepdim=True)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(_t(x), approximate="tanh")


def _elementwise_grad(fn):
    """d/dx of an elementwise fn, evaluated pointwise (jax.grad of the sum)."""
    return lambda x: torch.func.grad(lambda v: fn(v).sum())(_t(x))


_MAPS: dict[str, tuple] = {
    # kind: (fn, derivative map kind or None)
    "id": (lambda x: _t(x), "one"),
    "exp": (lambda x: torch.exp(_t(x)), "exp"),  # d/dx e^x = e^x
    "neg": (lambda x: -_t(x), "neg_one"),
    "relu": (lambda x: torch.clamp_min(_t(x), 0), "relu_grad"),
    "relu2": (lambda x: torch.square(torch.clamp_min(_t(x), 0)),
              "relu2_grad"),
    "silu": (lambda x: F.silu(_t(x)), "silu_grad"),
    "gelu": (_gelu, "gelu_grad"),
    "scale": (lambda x, c=1.0: _t(x) * c, "scale_grad"),
    "add_const": (lambda x, c=0.0: _t(x) + c, "one"),
    "rsqrt_eps": (lambda x, eps=1e-6: torch.rsqrt(_t(x) + eps),
                  "rsqrt_eps_grad"),
    # softmax_last is deliberately grad-less: its Jacobian is not diagonal,
    # so it is not derivative-map eligible (grad_graph raises).
    "softmax_last": (lambda x: _softmax(x, dim=-1), None),
    "sigmoid": (lambda x: torch.sigmoid(_t(x)), "sigmoid_grad"),
    "tanh": (lambda x: torch.tanh(_t(x)), "tanh_grad"),
    "square": (lambda x: torch.square(_t(x)), "two_x"),
    "cast_f32": (lambda x: _t(x).to(torch.float32), "one"),
}

#: derivative-only helper maps (no grad links of their own)
_DERIV_MAPS = {
    "relu_grad": lambda x: (_t(x) > 0).to(_t(x).dtype),
    "relu2_grad": lambda x: 2 * torch.clamp_min(_t(x), 0),
    "silu_grad": _elementwise_grad(F.silu),
    "tanh_grad": lambda x: 1 - torch.tanh(_t(x)) ** 2,
    "sigmoid_grad": lambda x: torch.sigmoid(_t(x)) * (1 - torch.sigmoid(_t(x))),
    "two_x": lambda x: 2 * _t(x),
    "scale_grad": lambda x, c=1.0: torch.full_like(_t(x), c),
    "one": lambda x, **_: torch.ones_like(_t(x)),
    "gelu_grad": _elementwise_grad(_gelu),
    "neg_one": lambda x: torch.full_like(_t(x), -1),
    # d/dx (x + eps)^(-1/2) = -1/2 (x + eps)^(-3/2)
    "rsqrt_eps_grad": lambda x, eps=1e-6: (
        -0.5 * torch.rsqrt(_t(x) + eps) / (_t(x) + eps)),
}

# check_impl=False everywhere below: loading this catalog must stay legal
# from the pure-planning path (a metadata-only registry consumer).
# derivative helpers first: defop validates grad= links eagerly
for _kind, _fn in _DERIV_MAPS.items():
    defop(_kind, None, fn=_fn, category="map",
          vjp_reason="derivative helper map — appears only in backward "
                     "graphs and is never itself differentiated")
for _kind, (_fn, _grad) in _MAPS.items():
    defop(_kind, None, fn=_fn, grad=_grad, category="map",
          vjp_reason=None if _grad is not None else
          "softmax Jacobian is not diagonal, so no derivative map exists; "
          "grad_graph rejects it and models differentiate the explicit "
          "exp/sum einsum form instead")


# ---------------------------------------------------------------------------
# Flash attention: signature over (batch, heads, kv-heads, q-seq, ring
# label, head_dim); the ring label ``l`` is what K/V circulate over — the
# model builders rename it to ``s`` (prefill, shared with q) or ``t``
# (decode, the kv-cache time label).
# ---------------------------------------------------------------------------


def _flash_attention_ref(q, k, v, causal=True, window=0, scale=None):
    """Dense reference (b h s d layout): the plain torch version."""
    from repro_torch.kernels import ops

    return ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, scale=scale, impl="ref")


def _flash_attention_kernel(q, k, v, causal=True, window=0, scale=None):
    """Accelerator dispatcher (kernels/ops.py): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors — what execution calls."""
    from repro_torch.kernels import ops

    return ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, scale=scale)


defop(
    "flash_attention", "b h s d, b k l d, b k l d -> b h s d",
    fn=_flash_attention_ref, kernel=_flash_attention_kernel, vjp="auto",
    check_impl=False, shardable="b h k l",
    comm=[{"kind": "ring", "label": "l", "input": 1},
          {"kind": "ring", "label": "l", "input": 2}],
    shard_rule="ring")


# ---------------------------------------------------------------------------
# Embedding gather: rows of a (vocab, d_model) table by int ids.  The ids
# are int32 (in_dtypes steers the registration check) and carry no
# gradient; the table grads flow through the auto VJP (a scatter-add).
# ---------------------------------------------------------------------------


def _gather_rows(table, ids):
    return _t(table)[_t(ids).long()]


defop("gather_rows", "v a, b s -> b s a", fn=_gather_rows, vjp="auto",
      check_impl=False, shardable="b s a", in_dtypes=(None, "int32"))


# ---------------------------------------------------------------------------
# Paged KV cache: the serving tier's block-table lookup (``pool (n, p, k,
# d)``, ``tables (b, w)`` -> time-ordered ``(b, k, t, d)``, ``t`` bound by
# the ``kv_len`` call param).  Batch / kv-heads / head_dim shard freely;
# ``t`` is priced as an all-to-all that the bound ``paged`` rule realizes
# with zero wire; the block-index labels n/p/w never shard.
# ---------------------------------------------------------------------------


def _kv_block_gather(pool, tables, kv_len):
    from repro_torch.kernels import ops

    return ops.kv_block_gather(_t(pool), _t(tables), int(kv_len))


defop(
    "kv_block_gather", "n p k d, b w -> b k t d",
    fn=_kv_block_gather, vjp="auto", check_impl=False,
    shardable="b k d t", param_bounds={"t": "kv_len"},
    in_dtypes=(None, "int32"),
    comm=[{"kind": "a2a", "label": "t", "input": -1, "rule": "paged"}],
    shard_rule="paged")


# ---------------------------------------------------------------------------
# broadcast_to: the autodiff adjoint carrier (labels/shape arrive as call
# params — fully dynamic, so no signature and no inference).
# ---------------------------------------------------------------------------


def _broadcast(x, src_labels, out_labels, out_shape):
    src = list(src_labels)
    for l in out_labels:
        if l not in src:
            x = x[..., None]
            src.append(l)
    x = x.permute([src.index(l) for l in out_labels])
    return x.expand(tuple(out_shape))


defop("broadcast_to", None,
      fn=lambda x, labels=(), shape=(), src_labels=(): (
          _broadcast(_t(x), src_labels, labels, shape)),
      vjp_reason="autodiff adjoint carrier — only ever *emitted by* the "
                 "backward pass, never differentiated through")


# ---------------------------------------------------------------------------
# MoE dispatch / combine: expert-parallel a2a schedule.  The capacity
# dimension ``c`` appears in no input — it binds from the ``capacity``
# call param (param_bounds).  Impls arrive with the MoE slice.
# ---------------------------------------------------------------------------

defop(
    "moe_dispatch", "b s a, b s e -> e c a",
    vjp_reason="discrete top-1 routing has no meaningful cotangent; MoE "
               "training backward is future work (ROADMAP)",
    shardable="e c b s", param_bounds={"c": "capacity"},
    comm=[{"kind": "a2a", "label": "e", "input": 0},
          {"kind": "a2a", "label": "c", "input": 0}],
    shard_rule="a2a")

defop(
    "moe_combine", "e c a, b s e -> b s a",
    vjp_reason="discrete top-1 routing has no meaningful cotangent; MoE "
               "training backward is future work (ROADMAP)",
    shardable="e c b s",
    # the moved buffer is the token-sided *output* (input -1): combine
    # returns each token its expert's result, it never moves the full
    # (e, c, a) expert buffer
    comm=[{"kind": "a2a", "label": "e", "input": -1},
          {"kind": "a2a", "label": "c", "input": -1}],
    shard_rule="a2a")


# ---------------------------------------------------------------------------
# Recurrent scans: sequence label is non-partitionable (recurrence), but
# the channel labels are — the ``local`` shard rule runs the scan per
# channel shard with zero collectives (sLSTM's dense recurrent matrix
# couples the whole width, so only b shards).  Impls arrive with the
# recurrent slice.
# ---------------------------------------------------------------------------

for _scan in ("ssm_scan", "mlstm_scan"):
    defop(_scan, "b s f -> b s f", shardable="b f", shard_rule="local",
          vjp="auto")
defop("slstm_scan", "b s f -> b s f", shardable="b", shard_rule="local",
      vjp="auto")
