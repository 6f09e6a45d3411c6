"""Checkpointing with async save — the reference's on-disk format, so a
checkpoint written by either package restores in the other.

Format: one directory per step with
  manifest.json   — step, extra metadata, per-leaf name/shape/dtype
  leafNNNNN.npy   — one file per tree leaf, numbered in ``jax.tree``'s
                    flattening order (``core/tree.py``: dict keys sorted,
                    an ``AdamWState`` as (step, m, v))

bfloat16 leaves are written widened to float32 (losslessly) and carry
their logical dtype in the manifest; restore narrows them back, so a
restored tree is bit-equal to the saved one.  Restore places every leaf on
the device of its counterpart in ``like``.

Async: ``CheckpointManager.save`` copies the tensors to host memory
synchronously and writes the files on a background thread, so the train
step is not blocked on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as tree_mod

#: dtypes numpy writes as they are; anything else is widened to float32
_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
           "uint8", "uint32", "uint64", "bool")


def _names(n: int) -> list[str]:
    return [f"leaf{idx:05d}" for idx in range(n)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, logical dtype name)."""
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


def save_checkpoint(path: str, step: int, tree: Any, *, extra: dict | None = None
                    ) -> None:
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = tree_mod.leaves(tree)
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


def load_checkpoint(path: str, like: Any) -> tuple[int, Any, dict]:
    """(step, tree shaped like ``like``, extra).  Each leaf goes to the
    device of its counterpart in ``like`` (the CPU where that is not a
    tensor)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n = len(tree_mod.leaves(like))
    if len(manifest["leaves"]) != n:
        raise ValueError(f"load_checkpoint: {path} holds "
                         f"{len(manifest['leaves'])} leaves, the tree {n}")
    dtypes = {l["name"]: l["dtype"] for l in manifest["leaves"]}
    names = iter(_names(n))

    def load(like_leaf):
        name = next(names)
        arr = np.load(os.path.join(path, name + ".npy"))
        t = torch.from_numpy(arr)
        logical = dtypes.get(name, str(arr.dtype))
        if logical != str(arr.dtype):  # widened on save (bfloat16)
            t = t.to(getattr(torch, logical))
        return t.to(like_leaf.device if isinstance(like_leaf, torch.Tensor) else "cpu")

    return manifest["step"], tree_mod.map(load, like), manifest["extra"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints under ``root``; async writes."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def latest(self) -> str | None:
        steps = self.all_steps()
        return self._dir(steps[-1]) if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             blocking: bool = False) -> None:
        self.wait()
        # copy to host memory now; write on a background thread
        host = tree_mod.map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.asarray(x), tree)

        def work():
            save_checkpoint(self._dir(step), step, host, extra=extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def restore_latest(self, like: Any):
        path = self.latest()
        if path is None:
            return None
        return load_checkpoint(path, like)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
