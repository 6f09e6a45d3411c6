"""Step functions shared by the trainer and the server: ``train_step``
(fwd + bwd + AdamW), ``prefill_step`` and ``serve_step``, and the serving
tier's ``bucket_prefill_step`` and ``paged_serve_step``; and
``GraphedStep``, which compiles a decode step the way the reference's
``jax.jit(..., donate_argnums=(2,))`` compiles it: one CUDA graph,
captured once and replayed every step, reading fixed input buffers and
writing the caches in place.

The reference jit-compiles every step.  Here the decode steps of
``launch.serve.serve`` and ``serving.ServingEngine`` replay a graph on a
card (``use_graph``); the prefills and the train step run eagerly.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import tree
from repro_torch.core.gspmd import full
from repro_torch.kernels import ops
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


# ---------------------------------------------------------------------------
# The compiled decode step
# ---------------------------------------------------------------------------


def use_graph(graph: bool | None, device, mesh=None) -> bool:
    """Whether a decode step runs as a captured CUDA graph.  ``graph=None``
    (the default, as the reference jits by default) captures on a card
    with no mesh of more than one rank and runs eagerly elsewhere: on the
    CPU there is nothing to capture, and on a mesh gloo's collectives and
    the MoE dispatch's count reads run on the host — the rule ``ops``'
    ``impl="auto"`` follows for the kernels.  ``graph=True`` asks for the
    graph and raises where that rule runs eagerly; ``graph=False`` asks
    for the eager step (the reference's ``jax.disable_jit``)."""
    placed = mesh is not None and mesh.world_size > 1
    capturable = torch.device(device).type == "cuda" and not placed
    if graph is None:
        return capturable
    if graph and not capturable:
        where = "a mesh of more than one rank" if placed else f"{device}"
        raise ValueError(f"a CUDA graph of the decode step was asked for on "
                         f"{where}: only a step on one card is captured "
                         "(graph=None runs it eagerly there)")
    return bool(graph)


class GraphedStep:
    """``fn(state, **inputs)`` compiled as the reference jits a decode
    step.  ``state`` is what the step writes in place (the caches: the
    port's form of ``donate_argnums=(2,)``); ``fn`` reads everything else
    it needs (the parameters) from its closure, and returns a tensor or a
    tuple of tensors.  The graph bakes in the addresses of all of them.

    ``inputs`` gives the fixed input buffers (``self.inputs``, copies of
    the tensors given: tokens, positions, block tables), which callers
    ``copy_`` or ``fill_`` before each call.  Each call returns the same
    fixed output buffers (``self.outputs``), overwritten by the next call:
    a caller that keeps an output past it clones it.

    With a graph (``use_graph``), the first call runs ``fn`` eagerly on a
    side stream, as PyTorch's graph capture wants its warm-up: the kernels
    are built and the libraries' handles made there, never under capture.
    That call is a real step, on the real state.  The second call captures
    ``fn`` into one ``torch.cuda.CUDAGraph`` and replays it, and every
    later call replays it.  The launch counters (``kernels.ops``) count
    what the card ran: the capture's counts are taken back and added once
    for each replay (``replays``).  A failed capture or replay raises; the
    step never falls back to eager.  Without a graph every call runs
    ``fn`` eagerly and copies its outputs into the same fixed buffers, so
    the CPU runs the plumbing the card runs, aliasing included.  ``graph``
    is taken as ``use_graph`` takes it with no mesh: a step on a mesh is
    given the rule's answer for it (``False``)."""

    def __init__(self, fn: Callable, state, inputs: dict, *,
                 graph: bool | None = None):
        self.fn, self.state = fn, state
        self.inputs = {k: v.detach().clone() for k, v in inputs.items()}
        self.device = next(iter(self.inputs.values())).device
        self.graphed = use_graph(graph, self.device)
        self.outputs: tuple | None = None
        self.replays = 0
        self._graph = None
        self._counts = None

    def __call__(self) -> tuple:
        if self._graph is not None:
            return self._replay()
        if not self.graphed:
            self._fill(self.fn(self.state, **self.inputs))
            return self.outputs
        if self.outputs is not None:
            self._capture()
            return self._replay()
        side, main = torch.cuda.Stream(self.device), torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._fill(self.fn(self.state, **self.inputs))
        main.wait_stream(side)
        for t in self.outputs:  # made on the side stream, read on this one
            t.record_stream(main)
        return self.outputs

    def _replay(self) -> tuple:
        self._graph.replay()
        ops.add_counts(self._counts)
        self.replays += 1
        return self.outputs

    def _fill(self, out) -> None:
        out = out if isinstance(out, tuple) else (out,)
        if self.outputs is None:
            self.outputs = tuple(o.detach().clone() for o in out)
        else:
            for fixed, o in zip(self.outputs, out):
                fixed.copy_(o)

    def _capture(self) -> None:
        before = ops.snapshot_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = self.fn(self.state, **self.inputs)
                out = out if isinstance(out, tuple) else (out,)
                for fixed, o in zip(self.outputs, out):
                    fixed.copy_(o)
            self._counts = ops.counts_since(before)
        finally:
            ops.restore_counts(before)  # capture launches nothing
        self._graph = graph
