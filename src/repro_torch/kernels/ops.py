"""Dispatching wrappers for the hand-written kernels.

``impl`` selects the implementation:
  * "auto"   — the CUDA kernel for a CUDA tensor, the plain torch version
               (``kernels/ref.py``) for a CPU tensor.  This is what the
               model stack calls.  A tensor on any other device reaches the
               kernel wrapper, which raises: nothing falls back silently.
  * "kernel" — the CUDA kernel; raises on a tensor that is not on a card.
  * "ref"    — the plain torch version, on whatever device the tensor is.

``launch_counts()`` reads each kernel's launch counter and
``reset_launch_counts()`` sets them to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
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
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset,
                               kv_offset=kv_offset)


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
    return {"flash_attention": _fa.flash_attention.launches}


def reset_launch_counts() -> None:
    _fa.flash_attention.launches = 0
