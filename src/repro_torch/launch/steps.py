"""Step functions shared by the trainer and the server: ``train_step``
(fwd + bwd + AdamW), ``prefill_step`` and ``serve_step``, and the serving
tier's ``bucket_prefill_step`` and ``paged_serve_step``; and
``GraphedStep``, which compiles a step the way the reference's
``jax.jit(..., donate_argnums=...)`` compiles it: one CUDA graph,
captured once and replayed every call, reading fixed input buffers and
writing its state (caches, parameters and moments) in place.

The reference jit-compiles every step.  Here, on a card with no mesh
(``use_graph``), the decode steps of ``launch.serve.serve`` and
``serving.ServingEngine``, the engine's bucket prefills with their
admission (one graph a bucket) and ``launch.train.train``'s step replay a
graph; ``serve()``'s one-shot prefill runs eagerly (one call a ``serve``
never reaches a capture), and so does every step on a mesh.
"""
from __future__ import annotations

import contextlib
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
    as 0-d tensors on the device.  ``batch`` holds ``tokens`` and
    ``labels``, and ``prefix_embeds`` where the config has a prefix
    (``loss_fn`` reads it).  ``lr_fn`` maps the step counter (a 0-d
    tensor on the device) to the learning rate, as the reference's traced
    step does: a tensor computed from it, or a float, which is a constant
    (a captured step replays the value it was captured with).  The step
    does no host read, so ``GraphedStep`` can capture it (``train``).

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
        step = opt_state.step
        lr = lr_fn(step)
        if not isinstance(lr, torch.Tensor):  # a fill, legal under capture
            lr = torch.full((), lr, dtype=torch.float32, device=step.device)
        params, opt_state, gnorm = adamw_update(
            params, grads, opt_state, lr, weight_decay=weight_decay)
        metrics = {k: full(v).detach() for k, v in metrics.items()}
        metrics.update({"loss": full(loss).detach(), "grad_norm": gnorm,
                        "lr": lr.to(torch.float32)})
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
    LM head runs at ``last_index`` (the last *real* token: an int, or a
    0-d integer tensor on the device, as the reference traces it) instead
    of the final, padded, position.  Structurally the same graph, so the
    two share a plan-cache entry per shape cell."""

    def bucket_prefill_step(params, batch, last_index):
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
# The compiled step
# ---------------------------------------------------------------------------


def use_graph(graph: bool | None, device, mesh=None) -> bool:
    """Whether a step runs as a captured CUDA graph.  ``graph=None``
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
        raise ValueError(f"a CUDA graph of the step was asked for on "
                         f"{where}: only a step on one card is captured "
                         "(graph=None runs it eagerly there)")
    return bool(graph)


_SIDE: dict = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` on which every step warms up and
    is captured.  The caching allocator keeps a freed block for the stream
    it was made on, in a graph's pool too: on one stream each warm-up
    reuses the blocks the last one freed, and each capture into a shared
    pool the blocks the other graphs left, where a stream a step would
    allocate them all afresh (cudaMalloc) and grow the pool by each."""
    device = torch.device(device)
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


class GraphedStep:
    """``fn(state, **inputs)`` compiled as the reference jits a step.
    ``state`` is what the step writes in place (the caches of a decode
    step or of an admission, the parameters and moments of a train step:
    the port's form of ``donate_argnums``); ``fn`` reads everything else
    it needs (the parameters of a serving step) from its closure, and
    returns a tensor or a tuple of tensors.  The graph bakes in the
    addresses of all of them.

    ``inputs`` gives the fixed input buffers (``self.inputs``, copies of
    the tensors given: tokens, positions, block tables), which callers
    ``copy_`` or ``fill_`` before each call.  Each call returns the same
    fixed output buffers (``self.outputs``), overwritten by the next call:
    a caller that keeps an output past it clones it.

    With a graph (``use_graph``), the first call runs ``fn`` eagerly on
    the side stream (``side_stream``), as PyTorch's graph capture wants its
    warm-up: the kernels
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
    given the rule's answer for it (``False``).

    ``pool`` (a ``torch.cuda.graph_pool_handle()``) lets several steps'
    graphs share one memory pool for what they allocate while they run,
    as the engine's bucket prefills do.  That is safe because every
    output and every piece of state lives outside the pool (the fixed
    buffers are made by the eager first call, the state by the caller),
    so nothing a graph leaves behind is in it, and because the graphs
    replay one at a time on one stream: each replay may overwrite all of
    the pool.  A caller that keeps a tensor made inside ``fn`` past the
    call breaks the first condition."""

    def __init__(self, fn: Callable, state, inputs: dict, *,
                 graph: bool | None = None, pool=None):
        self.fn, self.state, self.pool = fn, state, pool
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
        side, main = side_stream(self.device), torch.cuda.current_stream(self.device)
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
        """Capture ``fn`` on the side stream, as ``torch.cuda.graph`` does
        but without its synchronize and its emptying of the device and
        pinned host caches, which free every cached block: the calls after
        each capture would allocate afresh."""
        before = ops.snapshot_counts()
        graph = torch.cuda.CUDAGraph()
        side = side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool)
                try:
                    out = self.fn(self.state, **self.inputs)
                    out = out if isinstance(out, tuple) else (out,)
                    for fixed, o in zip(self.outputs, out):
                        fixed.copy_(o)
                except BaseException:
                    with contextlib.suppress(RuntimeError):  # the capture is void
                        graph.capture_end()
                    raise
                graph.capture_end()
            self._counts = ops.counts_since(before)
        finally:
            ops.restore_counts(before)  # capture launches nothing
        self._graph = graph
