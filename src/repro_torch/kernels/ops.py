"""Dispatching wrappers for the hand-written kernels.

``impl`` selects the implementation:
  * "auto"   — the CUDA kernel for a CUDA tensor, the plain torch version
               (``kernels/ref.py``) for a CPU tensor.  This is what the
               model stack calls.  A tensor on any other device reaches the
               kernel wrapper, which raises: nothing falls back silently —
               but for a meta tensor, which stands for one on a card in the
               dry run: the kernel's operator gives its output's shape.
  * "kernel" — the CUDA kernel; raises on a tensor that is not on a card.
  * "ref"    — the plain torch version, on whatever device the tensor is.

On a card the kernels differentiate: where grad mode is on and an input
requires grad, the forward, matmul and gmm wrappers launch their kernel
inside a ``torch.autograd.Function`` whose backward is the plain version's
(as the reference differentiates its dense reference, not its Pallas
kernels); the ring step, which updates its carry in place, raises.

``launch_counts()`` reads each kernel's launch counter,
``design_counts()`` splits every kernel's launches by the design that
served them (``"wgmma"``, ``"ffma"`` or ``"template"`` for every kernel:
the forward attention, the ring step, matmul and gmm; picked by each
wrapper's shape rule), and ``reset_launch_counts()``
sets them all to 0.  A wrapper bumps its counter when it runs, and under
a CUDA graph it runs only while the graph is captured, which launches
nothing: ``launch.steps.GraphedStep`` takes the counts of its capture
back (``snapshot_counts``, ``counts_since``, ``restore_counts``) and adds
them on every replay (``add_counts``), so the counters still say what
the card ran.

The forward attention, matmul and gmm launch through operators
(``repro_torch::flash_attention``, ``::matmul``, ``::gmm``), so that
abstract tensors — fake CUDA tensors (``FakeTensorMode``) and the meta
tensors the dry run (``launch/dryrun.py``) runs on — pass through them
without building or launching anything.  Those calls count apart, in
``fake_design_counts()``: the launches a rank would make, by design.
``launch_counts()`` and ``design_counts()`` count real launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref

IMPLS = ("auto", "kernel", "ref")


def _use_ref(impl: str, x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "ref" or (impl == "auto" and x.device.type == "cpu")


def flash_attention(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
                    kv_offset=0, impl: str = "auto"):
    if _use_ref(impl, q):
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                             q_offset=q_offset, kv_offset=kv_offset)
    return _fa.attention(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset, kv_offset=kv_offset)


def flash_attention_step(q, k, v, carry=None, *, causal=True, window=0,
                         scale=None, q_offset=0, kv_offset=0,
                         impl: str = "auto"):
    """One ring-attention step: fold a kv block into the carried f32
    ``(m, l, acc)``.  The kernel updates a given carry in place; the plain
    version returns new tensors.  Either way the carry passed in is
    consumed: use the returned one."""
    if _use_ref(impl, q):
        return ref.attention_step(q, k, v, carry, causal=causal, window=window,
                                  scale=scale, q_offset=q_offset,
                                  kv_offset=kv_offset)
    return _fa.flash_attention_step(q, k, v, carry, causal=causal,
                                    window=window, scale=scale,
                                    q_offset=q_offset, kv_offset=kv_offset)


def attention_finalize(carry, dtype):
    """Normalize a carried (m, l, acc) ring state to the attention output
    (``acc / l``, elementwise: plain torch, as in the reference)."""
    return ref.attention_finalize(carry, dtype)


def matmul(x, w, *, impl: str = "auto"):
    """(m, k) @ (k, n) with f32 accumulation, in x's dtype."""
    if _use_ref(impl, x):
        return ref.matmul(x, w)
    return _mm.product(x, w)


def gmm(x, w, *, impl: str = "auto"):
    """Grouped (expert) product (e, c, k) @ (e, k, n) -> (e, c, n), f32
    accumulation, in x's dtype."""
    if _use_ref(impl, x):
        return ref.gmm(x, w)
    return _gmm.grouped(x, w)


def kv_block_gather(pool, tables, kv_len: int):
    """Paged-KV block-table lookup: the serving tier's cache view.

    ``pool (n, p, k, d)`` is the block pool (``n`` blocks of ``p`` cache
    rows); ``tables (b, w)`` maps each sequence's block index to a pool row.
    Returns the gathered time-ordered cache ``(b, k, t, d)`` with ``t =
    kv_len <= w*p``; the padded tail of the last block is truncated.  A
    gather and a reshape, not a kernel (the reference has none either).
    """
    pool = torch.as_tensor(pool)
    tables = torch.as_tensor(tables).long()
    n, p, k, d = pool.shape
    b, w = tables.shape
    if kv_len > w * p:
        raise ValueError(
            f"kv_block_gather: kv_len={kv_len} exceeds the table capacity "
            f"w*p={w * p}")
    g = pool[tables.reshape(-1)]                          # (b*w, p, k, d)
    g = g.reshape(b, w * p, k, d)[:, :kv_len]
    return g.permute(0, 2, 1, 3)                          # (b, k, t, d)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"flash_attention": _fa.flash_attention.launches,
            "flash_attention_step": _fa.flash_attention_step.launches,
            "matmul": _mm.matmul.launches,
            "gmm": _gmm.gmm.launches}


def design_counts() -> dict[str, dict[str, int]]:
    """Launches since the last reset by kernel and design."""
    return {"flash_attention": dict(_fa.flash_attention.designs),
            "flash_attention_step": dict(_fa.flash_attention_step.designs),
            "matmul": dict(_mm.matmul.designs), "gmm": dict(_gmm.gmm.designs)}


def fake_design_counts() -> dict[str, dict[str, int]]:
    """Calls on fake tensors since the last reset, by kernel and design:
    the launches an abstract run would have made (the ring step takes no
    fake tensors)."""
    return {"flash_attention": dict(_fa.flash_attention.fake_designs),
            "matmul": dict(_mm.matmul.fake_designs),
            "gmm": dict(_gmm.gmm.fake_designs)}


_COUNTED = {"flash_attention": _fa.flash_attention,
            "flash_attention_step": _fa.flash_attention_step,
            "matmul": _mm.matmul, "gmm": _gmm.gmm}


def snapshot_counts() -> dict[str, tuple[int, dict[str, int]]]:
    """Every kernel's launch counter and its launches by design, as they
    stand (``counts_since``, ``restore_counts``)."""
    return {name: (fn.launches, dict(fn.designs)) for name, fn in _COUNTED.items()}


def counts_since(snap: dict) -> dict[str, tuple[int, dict[str, int]]]:
    """The launches, and the launches by design, counted since ``snap``."""
    now = snapshot_counts()
    return {name: (n - snap[name][0],
                   {d: c - snap[name][1][d] for d, c in designs.items()})
            for name, (n, designs) in now.items()}


def restore_counts(snap: dict) -> None:
    """Every counter back to ``snap``."""
    for name, (n, designs) in snap.items():
        _COUNTED[name].launches = n
        _COUNTED[name].designs = dict(designs)


def add_counts(delta: dict) -> None:
    """Add ``delta`` (``counts_since``'s) to the counters: the launches of
    one replay of a captured graph."""
    for name, (n, designs) in delta.items():
        fn = _COUNTED[name]
        fn.launches += n
        for d, c in designs.items():
            fn.designs[d] += c


def reset_launch_counts() -> None:
    """Every launch counter, and every count of fake calls, to 0."""
    for fn in _COUNTED.values():
        fn.launches = 0
        fn.designs = dict.fromkeys(fn.designs, 0)
        if hasattr(fn, "fake_designs"):
            fn.fake_designs = dict.fromkeys(fn.fake_designs, 0)
