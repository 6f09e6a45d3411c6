"""Continuous-batching serving engine on the plan cache.

``ServingEngine`` holds a fixed pool of decode *slots* (the persistent
paged-decode program's batch) plus an admission queue.  Each loop
iteration: (1) admit queued requests into free slots — a bucketed
batch-1 prefill through the ``BucketRegistry`` resolves the shape cell's
compiled handle (warm after first touch), then a scatter copies the
prefill caches into the paged KV pool under the request's block table,
and the recurrent states of hymba and xLSTM blocks into the slot's rows;
(2) run ONE batched decode step for all live slots — per-slot positions
and block tables mean requests join and leave mid-flight without any
replanning; (3) evict finished requests and return their blocks.

The steps are compiled as the reference jits them with the caches
donated, each as a ``launch.steps.GraphedStep``: on a card with no mesh
each replays a CUDA graph, reading its inputs from fixed device buffers
and writing the pools and states in place; ``graph=False`` runs them
eagerly, as the CPU and a mesh always do, through the same buffers.

* The decode step (the paged step and its greedy argmax): one graph,
  captured at the engine's second decode step.
* A bucket's prefill, its argmax and the admission of its caches into
  the pool (the reference's jitted bucket prefill, ``last_index`` traced,
  and its jitted admission, ``slot`` traced and the caches donated): one
  graph a bucket, keyed by the bucket's key and captured at the bucket's
  second use, reading the padded prompt, ``last_index``, the table row,
  ``slot`` and the decode token buffer; it returns the first token and the
  token buffer with it seeded.  One graph keeps the per-layer prefill
  caches inside it.  The bucket graphs share one memory pool (they replay
  one at a time on one stream, and nothing they leave behind is in it:
  ``GraphedStep``).  They bake in this engine's pool addresses, so the
  engine owns them, not the registry's entries.  A capture costs about
  two eager calls (the step's Python under capture, then the graph's
  instantiation), so a bucket's graph pays back over its next few
  replays, and an exact bucket used once runs eagerly, as before.

Generated tokens stay on the device (the decode step argmaxes on the
device and each step's tokens are cloned out of its fixed output buffer
into the step log); the host fetches everything once at drain, so the
loop never waits on a decode step.  The
one host sync per request is the prefill's argmax, which defines the time
to first token (the first token comes out of the same graph as the
admission, so TTFT includes the admission's copies).  Length-based
eviction is the default; passing ``eos_id``
enables early exit at the cost of one host sync per step (opt-in).

The block tables and positions live on the host as numpy arrays that the
loop mutates after every step; each step copies them into the step's
device buffers through a new pinned buffer on a card, so an asynchronous
copy never reads an array the host has already changed.

On a ``launch.mesh.Mesh`` of more than one rank every rank of the process
group builds the engine with the same arguments, submits the same
requests and runs the same scheduler: admission, eviction, the block
tables and positions are decided on the host from nothing that depends
on the rank, and the tokens are whole on every rank.  The weights and
caches are DTensors placed by the decode bucket's policy
(``transformer.place_params``, ``place_paged_caches``); each step runs on
each rank's blocks, and every rank returns the whole generations.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.gspmd import full
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.models.common import resolve_device
from repro_torch.serving.buckets import BucketRegistry
from repro_torch.serving.paged_kv import BlockAllocator, make_admit_fn


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new: int
    submit_t: float = 0.0
    ttft_s: float | None = None   # submit -> first token (prefill argmax)
    slot: int = -1
    blocks: list[int] = field(default_factory=list)
    step_start: int = -1          # index of its first decode-step column
    n_dec: int = 0                # decode tokens produced so far
    first_tok: int = -1
    done: bool = False

    @property
    def total(self) -> int:
        return 1 + self.n_dec     # prefill token + decode tokens


@dataclass
class ServeMetrics:
    """Serving-tier observability: queue depth and batch occupancy are
    sampled once per decode step; TTFT once per request."""

    queue_depth: list[int] = field(default_factory=list)
    occupancy: list[float] = field(default_factory=list)
    ttft_s: dict[int, float] = field(default_factory=dict)
    prefills: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    t_total_s: float = 0.0
    t_prefill_s: float = 0.0

    @property
    def tok_per_s(self) -> float:
        return self.tokens_generated / max(self.t_total_s, 1e-9)

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancy)) if self.occupancy else 0.0

    def summary(self) -> dict:
        return {
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "tokens_generated": self.tokens_generated,
            "tok_per_s": self.tok_per_s,
            "mean_occupancy": self.mean_occupancy,
            "max_queue_depth": max(self.queue_depth, default=0),
            "mean_ttft_s": (float(np.mean(list(self.ttft_s.values())))
                            if self.ttft_s else 0.0),
            "t_total_s": self.t_total_s,
            "t_prefill_s": self.t_prefill_s,
        }


def _fresh_into(buf: torch.Tensor, a: np.ndarray) -> None:
    """Copy ``a`` into the device buffer ``buf`` so that the caller may
    mutate ``a`` at once: on a card asynchronously out of a new pinned
    buffer (the caching host allocator keeps it until the copy is done),
    on the CPU synchronously."""
    t = torch.from_numpy(a)
    if buf.device.type == "cuda":
        buf.copy_(t.pin_memory(), non_blocking=True)
    else:
        buf.copy_(t)


class ServingEngine:
    """Continuous batching over a paged KV pool.

    Parameters
    ----------
    cfg:
        Model config (``repro_torch.configs``).
    batch:
        Decode slots — the persistent decode program's batch bucket.
    max_seq:
        Per-request capacity ceiling (prompt + generated), rounded up to
        whole blocks; sets the block-table width ``W``.
    block:
        KV block size (pool rows per block).
    n_blocks:
        Pool capacity.  Default sizes for all slots at full length plus
        the scratch block.
    params:
        The model's parameters, whole (moved to ``device``, and placed by
        the decode policy on a mesh); default seeded random weights made
        there (``tf.init_params(seed=seed)``, or
        ``tf.init_placed_params`` on a mesh).
    plan_cache:
        A ``PlanCache`` or the path of its JSON store, for the registry.
    bucket:
        Prefill bucket policy (``buckets.bucket_len``): "auto" (pow2 for
        pad-free archs, exact otherwise), "pow2", or "exact".
    eos_id:
        Optional early-exit token id.  Checking it costs one host sync
        per decode step, so it is opt-in; default is length-based
        eviction only.
    device:
        Where the engine runs; default the card, raising where there is
        none (the mesh's device where a mesh is given).
    mesh:
        A ``launch.mesh.Mesh`` (default: the one-device mesh).  On more
        than one rank the registry plans on its axes and the engine runs
        on DTensors, as the module docstring says.
    graph:
        ``None`` (default): the decode step and each bucket's prefill with
        its admission replay a CUDA graph on a card with no mesh and run
        eagerly elsewhere (``steps.use_graph``); ``False``: eagerly
        everywhere; ``True``: the graphs, raising where none can be
        captured.  The decode step is built at the first decode step from
        ``self._decode`` and ``self.params`` as they are then, a bucket's
        step at the bucket's first use from its registry entry's ``step``,
        ``self._admit`` and ``self.params`` (a caller may replace them
        before, to tap them: with a graph, what a tap does on the device
        is captured at the second call and replayed after, and a tap that
        reads the host cannot be captured).
    """

    def __init__(self, cfg, *, batch: int = 4, max_seq: int = 128,
                 block: int = 16, n_blocks: int | None = None, params=None,
                 seed: int = 0, plan_cache=None, bucket: str = "auto",
                 eos_id: int | None = None, device=None, mesh=None,
                 graph: bool | None = None):
        placed = mesh is not None and mesh.world_size > 1
        self.mesh = mesh if placed else None
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.graph = steps.use_graph(graph, self.device, self.mesh)
        self._step = None  # the compiled decode step, made at the first one
        self._prefills: dict[tuple, steps.GraphedStep] = {}  # by bucket key
        self._pool = None  # the bucket graphs' shared memory pool
        self.cfg = cfg
        self.batch = batch
        self.block = block
        self.W = -(-max_seq // block)
        self.seq = self.W * block
        self.eos_id = eos_id
        if n_blocks is None:
            n_blocks = 1 + batch * self.W
        self.alloc = BlockAllocator(n_blocks, block)
        self._admit = make_admit_fn(cfg)
        self.registry = BucketRegistry(cfg, mesh, plan_cache=plan_cache,
                                       bucket=bucket, device=self.device)

        dent = self.registry.decode(self.seq, batch, block)
        self.policy = dent.policy
        self._decode = dent.step
        if params is None:
            params = (tf.init_placed_params(cfg, self.policy, mesh, seed=seed)
                      if placed else
                      tf.init_params(cfg, seed=seed, device=self.device))
        else:
            params = tree.map(lambda t: t.to(self.device), params)
        self.params = tf.place_params(params, cfg, self.policy, self.mesh)

        self.caches = tf.place_paged_caches(
            tf.init_paged_caches(cfg, batch, n_blocks, block,
                                 device=self.device),
            cfg, batch, n_blocks, block, self.policy, self.mesh)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.tables = np.zeros((batch, self.W), np.int32)
        self.pos = np.zeros((batch,), np.int32)
        self.slots: list[Request | None] = [None] * batch
        self._queue: deque[Request] = deque()
        self._done: list[Request] = []
        self._next_rid = 0
        self._step_log: list[torch.Tensor] = []   # per-step (batch, 1) tokens
        self.metrics = ServeMetrics()

    # -- API ------------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        need = self.alloc.blocks_for(len(prompt) + max_new)
        if need > self.W:
            raise ValueError(f"request needs {need} blocks > table width "
                             f"{self.W} (raise max_seq)")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      submit_t=time.perf_counter())
        self._queue.append(req)
        return rid

    def run(self) -> tuple[dict[int, np.ndarray], ServeMetrics]:
        """Drain the queue; returns ({rid: (n_tokens,) int32}, metrics)."""
        t0 = time.perf_counter()
        # DTensor views cannot be made of inference tensors: no_grad on a mesh
        with torch.no_grad() if self.mesh is not None else torch.inference_mode():
            while self._queue or any(s is not None for s in self.slots):
                admitted = self._admit_phase()
                active = [s for s in self.slots if s is not None]
                if not active:
                    if self._queue and not admitted:
                        raise RuntimeError(
                            "admission deadlock: empty batch but queued "
                            "request cannot get blocks — pool too small for "
                            "one request")
                    continue
                self.metrics.queue_depth.append(len(self._queue))
                self.metrics.occupancy.append(len(active) / self.batch)
                self._decode_phase()
            results = self._drain()
        self.metrics.t_total_s += time.perf_counter() - t0
        return results, self.metrics

    # -- loop phases ----------------------------------------------------------

    def _admit_phase(self) -> int:
        admitted = 0
        while self._queue and None in self.slots:
            req = self._queue[0]
            blocks = self.alloc.alloc(
                self.alloc.blocks_for(len(req.prompt) + req.max_new))
            if blocks is None:
                break
            self._queue.popleft()
            self._prefill_into(req, self.slots.index(None), blocks)
            admitted += 1
        return admitted

    def _prefill_into(self, req: Request, slot: int, blocks: list[int]):
        t0 = time.perf_counter()
        plen = len(req.prompt)
        run = self._compiled_prefill(self.registry.prefill(plen))
        padded = np.zeros(run.inputs["tokens"].shape, np.int32)
        padded[0, :plen] = req.prompt
        row = np.zeros((self.W,), np.int32)
        row[:len(blocks)] = blocks
        _fresh_into(run.inputs["tokens"], padded)
        run.inputs["last_index"].fill_(plen - 1)
        _fresh_into(run.inputs["blocks"], row)
        run.inputs["slot"].fill_(slot)
        run.inputs["slot_tokens"].copy_(self.tokens)
        tok0, seeded = run()
        # TTFT is defined at the first token's availability: sync here (one
        # per request, not per step)
        req.first_tok = int(tok0[0])
        req.ttft_s = time.perf_counter() - req.submit_t
        self.metrics.ttft_s[req.rid] = req.ttft_s
        self.metrics.prefills += 1

        self.tables[slot] = row
        self.pos[slot] = plen
        # the fixed output buffer is rewritten by the bucket's next call
        self.tokens = seeded.clone()
        req.slot, req.blocks = slot, blocks
        req.step_start = len(self._step_log)
        self.slots[slot] = req
        self.metrics.t_prefill_s += time.perf_counter() - t0
        if req.max_new == 1:
            self._evict(req)

    def _compiled_prefill(self, ent) -> steps.GraphedStep:
        """The bucket's prefill, argmax and admission as one compiled step
        (the module docstring), made at the bucket's first use."""
        run = self._prefills.get(ent.key)
        if run is not None:
            return run
        prefill, admit, params = ent.step, self._admit, self.params

        def step(caches, tokens, last_index, blocks, slot, slot_tokens):
            logits, pre_caches = prefill(params, {"tokens": tokens}, last_index)
            tok0 = torch.argmax(full(logits)[:, -1], dim=-1).to(torch.int32)  # (1,)
            _, seeded = admit(caches, pre_caches, blocks, slot, tok0, slot_tokens)
            return tok0, seeded

        if self.graph and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        dev, index = self.device, torch.zeros((), dtype=torch.long, device=self.device)
        run = steps.GraphedStep(
            step, self.caches,
            {"tokens": torch.zeros((1, ent.key[2]), dtype=torch.int32, device=dev),
             "last_index": index, "blocks": torch.zeros((self.W,), dtype=torch.int32,
                                                        device=dev),
             "slot": index, "slot_tokens": self.tokens},
            graph=self.graph, pool=self._pool)
        self._prefills[ent.key] = run
        return run

    def _compiled_step(self) -> steps.GraphedStep:
        if self._step is None:
            decode, params = self._decode, self.params  # no cycle through self

            def step(caches, tokens, tables, pos):
                return decode(params, tokens, caches, tables, pos)[0]

            dev = self.device
            self._step = steps.GraphedStep(
                step, self.caches,
                {"tokens": self.tokens,
                 "tables": torch.zeros(self.tables.shape, dtype=torch.int32, device=dev),
                 "pos": torch.zeros(self.pos.shape, dtype=torch.int32, device=dev)},
                graph=self.graph)
        return self._step

    def _decode_phase(self):
        run = self._compiled_step()
        run.inputs["tokens"].copy_(self.tokens)
        _fresh_into(run.inputs["tables"], self.tables)
        _fresh_into(run.inputs["pos"], self.pos)
        # the fixed output buffer is overwritten by the next step: log a clone
        tok = run()[0].clone()
        self.tokens = tok
        self._step_log.append(tok)
        self.metrics.decode_steps += 1
        eos_row = (tok[:, 0].cpu().numpy()
                   if self.eos_id is not None else None)  # opt-in sync
        for req in list(self.slots):
            if req is None:
                continue
            req.n_dec += 1
            self.pos[req.slot] += 1
            hit_eos = (eos_row is not None
                       and eos_row[req.slot] == self.eos_id)
            if req.total >= req.max_new or hit_eos:
                self._evict(req)

    def _evict(self, req: Request):
        self.alloc.release(req.blocks)
        self.tables[req.slot] = 0
        self.pos[req.slot] = 0
        self.slots[req.slot] = None
        req.done = True
        self._done.append(req)

    def _drain(self) -> dict[int, np.ndarray]:
        if self._step_log:
            mat = torch.cat(self._step_log, dim=1).cpu().numpy()
        else:
            mat = np.zeros((self.batch, 0), np.int32)
        out: dict[int, np.ndarray] = {}
        for req in self._done:
            cols = range(req.step_start, req.step_start + req.n_dec)
            gen = np.asarray(
                [req.first_tok] + [int(mat[req.slot, j]) for j in cols],
                np.int32)
            self.metrics.tokens_generated += len(gen)
            out[req.rid] = gen
        self._step_log.clear()
        self._done.clear()
        return out
