"""Step functions shared by the trainer and the server: ``train_step``
(fwd + bwd + AdamW), ``prefill_step`` and ``serve_step``, and the serving
tier's ``bucket_prefill_step`` and ``paged_serve_step``.

The reference jit-compiles these; PyTorch runs them eagerly.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import tree
from repro_torch.core.gspmd import full
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import adamw_update


def make_train_step(cfg, *, policy=None, mesh=None,
                    lr_fn: Callable | None = None,
                    weight_decay: float = 0.1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients through ``torch.autograd`` (each
    unit rematerialized as the policy says, ``loss_fn``), then
    ``adamw_update``, which writes the parameters and moments in place.
    ``metrics`` holds ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``
    as 0-d tensors.  ``batch`` holds ``tokens`` and ``labels``, and
    ``prefix_embeds`` where the config has a prefix (``loss_fn`` reads
    it).

    On a mesh of more than one rank the parameters and moments are
    DTensors (``transformer.place_params``, ``adamw_init``) and so is the
    batch (``data.synthetic.place_batch``); each gradient is pinned to its
    parameter's placements before AdamW — the reference's ``gshard``: a
    ``Partial`` gradient of a data-sharded batch becomes a reduce-scatter
    into the parameter's shard (an all-reduce where the parameter is
    replicated).  The metrics come back whole on every rank.  On one rank
    there is nothing to pin (``gshard`` is the identity there)."""
    lr_fn = lr_fn or (lambda step: 3e-4)
    placed = mesh is not None and mesh.world_size > 1

    def train_step(params, opt_state, batch):
        leaves = tree.leaves(params)
        tracked = [p.requires_grad for p in leaves]
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch, cfg, policy=policy,
                                    mesh=mesh)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p, was in zip(leaves, tracked):
                p.requires_grad_(was)
        if placed:  # gshard: each gradient in its parameter's placements
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        grads = _like(params, grads)
        lr = lr_fn(opt_state.step)
        params, opt_state, gnorm = adamw_update(
            params, grads, opt_state, lr, weight_decay=weight_decay)
        metrics = {k: full(v).detach() for k, v in metrics.items()}
        metrics.update({"loss": full(loss).detach(), "grad_norm": gnorm,
                        "lr": torch.as_tensor(lr, dtype=torch.float32)})
        return params, opt_state, metrics

    return train_step


def _like(params, flat: list):
    """``flat`` (in ``tree.leaves`` order) shaped as ``params``."""
    it = iter(flat)
    return tree.map(lambda _: next(it), params)


def make_prefill_step(cfg, *, policy=None, mesh=None) -> Callable:
    """``prefill_step(params, batch) -> (logits (b, 1, v), caches)``;
    ``batch["prefix_embeds"]``, where given, goes before the tokens.  On a
    mesh of more than one rank the logits and caches are DTensors."""

    def prefill_step(params, batch):
        logits, caches, _ = tf.forward(params, batch["tokens"], cfg,
                                       prefix_embeds=batch.get("prefix_embeds"),
                                       policy=policy, mesh=mesh,
                                       collect_cache=True, last_logit_only=True)
        return logits, caches

    return prefill_step


def make_serve_step(cfg, *, policy=None, mesh=None) -> Callable:
    """``serve_step(params, tokens, caches, pos) -> (logits, caches)``,
    the caches written in place (DTensors on a mesh of more than one
    rank, as ``transformer.place_caches`` places them)."""
    def serve_step(params, tokens, caches, pos):
        return tf.decode_step(params, tokens, caches, pos, cfg,
                              policy=policy, mesh=mesh)

    return serve_step


def make_bucket_prefill_step(cfg, *, policy=None, mesh=None) -> Callable:
    """Prefill over a bucket-padded prompt: ``prefill_step`` except that the
    LM head runs at ``last_index`` (the last *real* token) instead of the
    final, padded, position.  Structurally the same graph, so the two share
    a plan-cache entry per shape cell."""

    def bucket_prefill_step(params, batch, last_index: int):
        logits, caches, _ = tf.forward(params, batch["tokens"], cfg,
                                       prefix_embeds=batch.get("prefix_embeds"),
                                       policy=policy, mesh=mesh,
                                       collect_cache=True,
                                       logit_index=last_index)
        return logits, caches

    return bucket_prefill_step


def make_paged_serve_step(cfg, *, policy=None, mesh=None) -> Callable:
    """Continuous-batching decode step: per-slot positions and block tables
    into the paged KV pools (``kv_block_gather``).  On a mesh of more than
    one rank the parameters and caches are DTensors
    (``transformer.place_params``, ``place_paged_caches``), placed by
    ``policy``, and the logits come back as a DTensor
    (``transformer.decode_step_paged``)."""

    def paged_serve_step(params, tokens, caches, tables, pos):
        return tf.decode_step_paged(params, tokens, caches, tables, pos, cfg,
                                    policy=policy, mesh=mesh)

    return paged_serve_step
