"""Checkpointing with async save and elastic (resharding) restore — the
reference's on-disk format, so a checkpoint written by either package
restores in the other, whatever mesh wrote it.

Format: one directory per step with
  manifest.json   — step, extra metadata, per-leaf name/shape/dtype
  leafNNNNN.npy   — one file per tree leaf, the whole leaf, numbered in
                    ``jax.tree``'s flattening order (``core/tree.py``: dict
                    keys sorted, an ``AdamWState`` as (step, m, v))

bfloat16 leaves are written widened to float32 (losslessly) and carry
their logical dtype in the manifest; restore narrows them back, so a
restored tree is bit-equal to the saved one.

A tree of a run on a mesh of more than one rank holds DTensor leaves.
Every rank takes part in its save, one leaf at a time, on the main
thread: each rank sends its block of a DTensor leaf to rank 0 (host
copies, ``dist.gather``), which assembles the whole leaf on its host, so
no rank holds more than one whole leaf beside its own blocks, and none on
its card.  Only rank 0 writes, renames and collects old steps, and a
save ends (``CheckpointManager.wait``, a blocking save) in a barrier, so
no rank reads a step before it is complete.

Restore takes the mesh of the restarted run, which may differ from the
one that saved (``shardings=``, or the placements of ``like``'s DTensor
leaves): each rank reads the files memory-mapped and copies only its own
block to its device, so restore moves no data between ranks.  Ranks that
share a card take turns.  ``CheckpointManager.restore_latest`` reads the
step rank 0 chooses, so every rank restores the same one.

Async: ``CheckpointManager.save`` copies the tensors to host memory
synchronously and writes the files on a background thread, so the train
step is not blocked on disk.  No collective runs on that thread.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import tree as tree_mod

#: dtypes numpy writes as they are; anything else is widened to float32
_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
           "uint8", "uint32", "uint64", "bool")


def _names(n: int) -> list[str]:
    return [f"leaf{idx:05d}" for idx in range(n)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, logical dtype name) of a host tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if logical not in _NATIVE:
        arr = arr.astype(np.float32)
    return arr, logical


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _placed(tree) -> bool:
    """Whether ``tree`` holds a DTensor on a mesh of more than one rank."""
    return any(isinstance(x, DTensor) and x.device_mesh.size() > 1
               for x in tree_mod.leaves(tree))


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _gather_leaf(x: DTensor, keep: bool):
    """The whole of DTensor ``x`` on the host of rank 0 (None elsewhere):
    every rank copies its block to the host and ``dist.gather``s it, with
    the block's offset and shape, to rank 0, which places each block in
    the whole tensor.  No rank holds more of ``x`` on its card than its
    own block."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(placements=[Replicate() if p.is_partial() else p
                                       for p in x.placements])
    # the block's bytes: gloo gathers them whatever the dtype
    block = x.to_local().detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
    where = compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                  x.placements)
    metas = [None] * dist.get_world_size()
    dist.all_gather_object(metas, (where, block.numel()))
    n = max(m[1] for m in metas)
    if block.numel() < n:  # gather takes blocks of one size: pad the short ones
        block = torch.cat([block, block.new_zeros(n - block.numel())])
    if not keep:
        dist.gather(block, None, dst=0)
        return None
    whole = torch.empty(x.shape, dtype=x.dtype)
    flat = whole.reshape(-1).view(torch.uint8)
    ranges = [_byte_range(x.shape, shape, offset, whole.element_size())
              for (shape, offset), _ in metas]
    if all(r is not None and r[1] - r[0] == n for r in ranges):
        # every block is one run of the whole's bytes: received in place
        dist.gather(block, [flat[a:b] for a, b in ranges], dst=0)
        return whole
    got = [torch.empty_like(block) for _ in metas]
    dist.gather(block, got, dst=0)
    for ((shape, offset), nbytes), b in zip(metas, got):
        whole[tuple(slice(o, o + s) for o, s in zip(offset, shape))] = \
            b[:nbytes].view(x.dtype).reshape(shape)
    return whole


def _byte_range(whole, shape, offset, itemsize: int):
    """(first, last + 1) byte of a block of a row-major ``whole`` at
    ``offset`` where the block is one contiguous run of it, else None."""
    inner = [d for d, (s, w) in enumerate(zip(shape, whole)) if s != w]
    if inner and any(s != 1 for s in shape[:inner[0]]):
        return None
    if inner and any(s != w for s, w in zip(shape[inner[0] + 1:], whole[inner[0] + 1:])):
        return None
    start, stride = 0, 1
    for o, w in zip(reversed(offset), reversed(whole)):
        start += o * stride
        stride *= w
    return start * itemsize, (start + math.prod(shape)) * itemsize


def _gather(tree) -> Any:
    """``tree`` whole on the host (a copy: the train step writes its
    tensors in place): on rank 0 where the tree is placed, ``None`` on the
    other ranks, which all call this, leaf by leaf in the same order: each
    DTensor leaf is gathered to rank 0 (``_gather_leaf``, a collective)."""
    keep = not _placed(tree) or _rank() == 0

    def host(x):
        if isinstance(x, DTensor):
            return _gather_leaf(x, keep)
        if not keep:
            return None
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return np.array(x, copy=True)

    out = tree_mod.map(host, tree)
    return out if keep else None


def _write(path: str, step: int, host: Any, extra: dict | None) -> None:
    """Write a host tree as ``path`` (through ``path.tmp``, renamed)."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = tree_mod.leaves(host)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for leaf, name in zip(leaves, _names(len(leaves))):
        arr, logical = _to_host(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_checkpoint(path: str, step: int, tree: Any, *, extra: dict | None = None
                    ) -> None:
    """Write ``tree`` as the checkpoint directory ``path``.  A tree with
    DTensor leaves is saved by every rank of their mesh together: the
    leaves gathered to rank 0, which alone writes; it returns on every
    rank once the directory is complete."""
    placed = _placed(tree)
    host = _gather(tree)
    if host is not None:
        _write(path, step, host, extra)
    if placed:
        dist.barrier()


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _paired(like, shardings) -> list:
    """``shardings``' entry for every leaf of ``like``, in leaf order: the
    object at the leaf's position, ``None`` under a ``None`` subtree."""
    if like is None:
        return []
    if shardings is None:
        return [None] * len(tree_mod.leaves(like))
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _paired(like[k], shardings[k])]
    if isinstance(like, (list, tuple)):
        return [s for a, b in zip(like, shardings) for s in _paired(a, b)]
    return [shardings]


def _target(like_leaf, spec, mesh):
    """(device, DeviceMesh, placements) a restored leaf takes: ``spec`` on
    ``mesh``, else the placements of a DTensor ``like_leaf``; the device
    mesh and placements are None for a leaf restored whole."""
    from repro_torch.core import gspmd

    if spec is not None:
        if mesh is None:
            raise ValueError("load_checkpoint: shardings given as specs need "
                             "the mesh they refer to (mesh=)")
        if mesh.world_size == 1:
            return mesh.device, None, None
        return (mesh.device, mesh.dmesh,
                gspmd.placements(gspmd.nested(spec, mesh), mesh))
    if isinstance(like_leaf, DTensor):
        return (like_leaf.to_local().device, like_leaf.device_mesh,
                tuple(like_leaf.placements))
    if isinstance(like_leaf, torch.Tensor):
        return like_leaf.device, None, None
    return torch.device("cpu"), None, None


def _read(path: str, name: str, logical: str, target) -> torch.Tensor:
    """One leaf from its file, memory-mapped: the whole leaf, or this
    rank's block of it (only that block is read and copied)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    device, dmesh, pl = target
    arr = np.load(os.path.join(path, name + ".npy"), mmap_mode="r")
    if dmesh is not None:
        shape, offset = compute_local_shape_and_global_offset(arr.shape, dmesh, pl)
        block = arr[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
    else:
        block = arr
    t = torch.from_numpy(np.array(block, copy=True))
    if logical != str(arr.dtype):  # widened on save (bfloat16)
        t = t.to(getattr(torch, logical))
    t = t.to(device)
    if dmesh is None:
        return t
    from repro_torch.core.gspmd import _contiguous_stride

    return DTensor.from_local(t, dmesh, pl, run_check=False,
                              shape=torch.Size(arr.shape),
                              stride=_contiguous_stride(arr.shape))


def _shares_card(targets) -> bool:
    """Whether the placed leaves' ranks share cards (more ranks than cards)."""
    return any(dm is not None and dm.size() > 1 and dev.type == "cuda"
               and torch.cuda.device_count() < dist.get_world_size()
               for dev, dm, _ in targets)


def load_checkpoint(path: str, like: Any, *, shardings: Any = None, mesh=None
                    ) -> tuple[int, Any, dict]:
    """(step, tree shaped like ``like``, extra).

    ``shardings``, as in the reference, says where each leaf goes on the
    restarted run's mesh: ``None``, or a tree mirroring ``like`` (``None``
    standing for a whole subtree) whose leaves are specs — one entry per
    dim, ``None``, an axis name or a tuple of axis names, as
    ``transformer.param_specs`` gives them — on the ``launch.mesh.Mesh``
    ``mesh``.  A leaf with no spec takes the placements of its counterpart
    in ``like`` where that is a DTensor, else it is restored whole on the
    device of its counterpart (the CPU where that is not a tensor).  A
    placed leaf becomes a DTensor whose block on this rank is read from
    the memory-mapped file alone: no rank moves data to another.  Ranks
    that share a card take turns, a barrier apart, so every rank of the
    mesh calls this."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = tree_mod.leaves(like)
    n = len(like_leaves)
    if len(manifest["leaves"]) != n:
        raise ValueError(f"load_checkpoint: {path} holds "
                         f"{len(manifest['leaves'])} leaves, the tree {n}")
    dtypes = {l["name"]: l["dtype"] for l in manifest["leaves"]}
    targets = [_target(l, s, mesh) for l, s in zip(like_leaves,
                                                     _paired(like, shardings))]

    def read_all() -> list:
        return [_read(path, name, dtypes[name], tgt)
                for name, tgt in zip(_names(n), targets)]

    if _shares_card(targets):
        for r in range(dist.get_world_size()):
            if r == dist.get_rank():
                out = read_all()
            dist.barrier()
    else:
        out = read_all()
    it = iter(out)
    return manifest["step"], tree_mod.map(lambda _: next(it), like), manifest["extra"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints under ``root``; async writes.
    On a mesh of more than one rank every rank makes one and calls
    ``save``, ``wait`` and ``restore_latest`` alike; rank 0 writes."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._placed = False  # the last save's tree was placed

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def latest(self) -> str | None:
        steps = self.all_steps()
        return self._dir(steps[-1]) if steps else None

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.root):
            return []
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def wait(self) -> None:
        """Until the last save is on disk, on every rank (a barrier after a
        placed save)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._placed:
            dist.barrier()
            self._placed = False

    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             blocking: bool = False) -> None:
        self.wait()
        # gather to rank 0's host memory now; write on a background thread
        self._placed = _placed(tree)
        host = _gather(tree)
        if host is not None:
            def work():
                _write(self._dir(step), step, host, extra)
                self._gc()

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def restore_latest(self, like: Any, *, shardings: Any = None, mesh=None):
        """``load_checkpoint`` of the latest step (None where there is
        none).  On a mesh of more than one rank — ``mesh``, or ``like``'s
        DTensor leaves — rank 0 chooses the step and broadcasts it."""
        steps = self.all_steps()
        step = steps[-1] if steps else None
        if _placed(like) or (mesh is not None and mesh.world_size > 1):
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        if step is None:
            return None
        return load_checkpoint(self._dir(step), like, shardings=shardings,
                               mesh=mesh)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
