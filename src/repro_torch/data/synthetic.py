"""Deterministic synthetic token pipeline.

Every global step maps to a unique counter-based seed, so (a) a restarted
or elastically-rescaled run replays *exactly* the same global batches
(straggler/preemption recovery, DESIGN.md §7), and (b) each host
materializes only its addressable shard of the global batch.

The synthetic distribution is a Zipf-ish unigram mix with short repeated
motifs — enough structure that a real model's loss visibly drops, which the
training examples assert.

The generator is numpy, copied from the reference (``repro/data``), so both
packages give the same batches bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticLM:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._motifs = rng.integers(
            0, self.vocab, size=(self.n_motifs, self.motif_len))
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The full (global_batch, seq) batch for a step — deterministic."""
        rows = [self._row(step, i) for i in range(self.global_batch)]
        toks = np.stack(rows).astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def host_batch_at(self, step: int, host_index: int, num_hosts: int
                      ) -> dict[str, np.ndarray]:
        """Only this host's contiguous rows of the global batch."""
        per = self.global_batch // num_hosts
        rows = [self._row(step, host_index * per + i) for i in range(per)]
        toks = np.stack(rows).astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))
        out = rng.choice(self.vocab, size=self.seq, p=self._unigram)
        # splice motifs for learnable short-range structure
        n = max(1, self.seq // (4 * self.motif_len))
        for _ in range(n):
            m = rng.integers(0, self.n_motifs)
            pos = rng.integers(0, max(1, self.seq - self.motif_len))
            out[pos : pos + self.motif_len] = self._motifs[m]
        return out


def batch_shardings(policy, mesh, batch_spec: dict) -> dict:
    """Placements for a batch dict, as the reference's NamedShardings:
    tokens and labels on ``"b s"``, prefix embeddings on ``"b s a"``,
    ``pos`` unplaced (None).  ``batch_spec`` maps each name to its shape
    (anything with ``.shape``, or a shape tuple), which makes the spec
    safe for it; a value of None skips that check.  The placements are
    one per axis of ``mesh`` (a ``launch.mesh.Mesh`` or ``{axis: size}``);
    on a one-rank mesh every entry is Replicate."""
    out = {}
    for k, v in batch_spec.items():
        if k == "pos":
            out[k] = None
            continue
        labels = "b s a" if k == "prefix_embeds" else "b s"
        shape = getattr(v, "shape", v)
        out[k] = policy.sharding(mesh, labels, None if shape is None
                                 else tuple(shape))
    return out


def place_batch(batch: dict, policy, mesh) -> dict:
    """A host batch (numpy arrays or tensors, whole on every rank) on
    ``mesh``: on a mesh of more than one rank each entry becomes a DTensor
    of its ``batch_shardings`` placements (each rank keeps its block, no
    collective); on one rank each becomes a tensor on ``mesh.device``."""
    import torch

    if mesh.world_size <= 1:
        return {k: torch.as_tensor(np.asarray(v), device=mesh.device)
                for k, v in batch.items()}
    from repro_torch.core.gspmd import distribute
    from repro_torch.models.policy import safe_spec

    out = {}
    for k, v in batch.items():
        labels = "b s a" if k == "prefix_embeds" else "b s"
        a = np.asarray(v)
        spec = safe_spec(policy.act_spec(labels), a.shape, mesh)
        out[k] = distribute(torch.as_tensor(a), mesh, spec)
    return out
