"""Serving driver: batched prefill + greedy decode loop with KV caches.

``serve`` declares the cell's model graph, plans it through the plan cache
(the paper's pipeline: ``program_for`` -> ``Program.compile`` -> §8 DP or a
cache hit -> ``policy()``), then prefills the batch of prompts in one
forward (one flash-attention kernel launch per layer on a card), copies the
collected K/V into preallocated decode caches and decodes greedily, writing
each step's K/V into those caches in place.  Sliding-window archs keep
ring-buffer caches.  On a card the decode step and its argmax replay one
CUDA graph per step, captured once a call (``steps.GraphedStep``), as the
reference jits its decode step and donates the caches;
``serve(graph=False)`` decodes eagerly.

With ``--executor shard_map`` the cell's program is also compiled for the
explicit-collective executor on the one-rank mesh, and its static
collective schedule is printed (the serving steps themselves still run the
model stack, as in the reference).

``serve(mesh=...)`` on a ``launch.mesh.Mesh`` of more than one rank (each
rank a process, ``launch.mesh.spawn``) plans on the mesh's axes, places
the weights by ``transformer.param_shardings`` and runs prefill and decode
under the projected policy on DTensors, the caches placed by
``cache_shardings``; every rank returns the whole generations.  The CLI
stays one process.

``--continuous`` switches to the serving tier proper
(``repro_torch.serving.ServingEngine``): slot-based continuous batching
over a paged KV-block pool, with prefill programs resolved through the
shape-bucket registry and the plan cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \
        --reduced --continuous --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --reduced --device cpu   # also xlstm-125m, paligemma-3b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tree
from repro_torch.core.gspmd import full, run_local
from repro_torch.core.plancache import PlanCache
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.common import resolve_device
from repro_torch.models.eingraphs import program_for

#: the planner's mesh on one device (what the reference's make_host_mesh
#: gives on one device)
ONE_DEVICE_MESH = {"data": 1, "model": 1}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ring_pack(cache_kv: KVCache, prompt_len: int, window: int) -> KVCache:
    """Re-pack a prefill cache (time-ordered) into decode ring order.
    Layout is (L, b, S, kh, hd) stacked per unit."""
    take = min(window, prompt_len)
    slots = (prompt_len - take + torch.arange(take)) % window

    def pack(x):
        ring = torch.zeros(x.shape[:2] + (window,) + x.shape[3:],
                           dtype=x.dtype, device=x.device)
        ring[:, :, slots.to(x.device)] = x[:, :, prompt_len - take:prompt_len]
        return ring

    return KVCache(pack(cache_kv.k), pack(cache_kv.v))


def _decode_kv(cfg, k, v, prompt_len: int, kv_len: int) -> KVCache:
    """One block's (units, b, kv_len, kv_heads, hd) decode buffers holding
    the prompt's K/V (ring order for windowed archs)."""
    if cfg.window:
        return _ring_pack(KVCache(k, v), prompt_len, kv_len)
    shape = k.shape[:2] + (kv_len,) + k.shape[3:]
    kv = KVCache(k.new_zeros(shape), v.new_zeros(shape))
    kv.k[:, :, :prompt_len] = k
    kv.v[:, :, :prompt_len] = v
    return kv


def prepare_decode_caches(cfg, prefill_caches, prompt_len: int, kv_len: int,
                          *, policy=None, mesh=None):
    """Convert prefill-collected caches into decode-ready buffers: per
    pattern position, the KV of attn and hymba blocks in (units, b,
    kv_len, kv_heads, hd) buffers holding the prompt's K/V (ring order for
    windowed archs); hymba keeps its SSM state beside them, and mlstm and
    slstm states pass through untouched (decode writes them in place).
    On a mesh of more than one rank the prefill K/V are DTensors and the
    buffers are made on each rank's blocks, placed by
    ``transformer.cache_shardings``."""
    if mesh is not None and mesh.world_size > 1:
        return _placed_decode_caches(cfg, prefill_caches, prompt_len, kv_len,
                                     policy, mesh)
    out = []
    for blk, cache in zip(cfg.block_pattern, prefill_caches):
        if blk not in ("attn", "hymba"):
            out.append(cache)
            continue
        k, v = cache[0] if blk == "hymba" else cache
        kv = _decode_kv(cfg, k, v, prompt_len, kv_len)
        out.append((kv, cache[1]) if blk == "hymba" else kv)
    return out


def _placed_decode_caches(cfg, prefill_caches, prompt_len, kv_len, policy,
                          mesh):
    """``prepare_decode_caches`` on DTensors: each attn or hymba block's
    decode buffers are made on each rank's (batch, kv-head) blocks of the
    prefill K/V, the time dim whole, then placed by ``cache_specs`` (a
    split time dim is a local slice); the recurrent states are placed
    there as they are."""
    from repro_torch.core.gspmd import constrain

    batch = tree.leaves(prefill_caches)[0].shape[1]  # (L, b, ...) leaves
    specs = tf.cache_specs(cfg, batch, kv_len, policy, mesh)
    out = []
    for blk, cache, spec in zip(cfg.block_pattern, prefill_caches, specs):
        if blk not in ("attn", "hymba"):
            out.append(type(cache)(*(constrain(t, mesh, sp)
                                     for t, sp in zip(cache, spec))))
            continue
        (k, v), kv_spec = (cache[0], spec[0]) if blk == "hymba" else (cache, spec)
        whole = kv_spec.k[:2] + (None,) + kv_spec.k[3:]  # (L, b, t, k, d)
        kv = KVCache(*(constrain(t, mesh, kv_spec.k) for t in run_local(
            lambda k, v: tuple(_decode_kv(cfg, k, v, prompt_len, kv_len)),
            (k, v), (whole, whole), (whole, whole), mesh)))
        if blk == "hymba":
            kv = (kv, type(cache[1])(*(constrain(t, mesh, sp)
                                       for t, sp in zip(cache[1], spec[1]))))
        out.append(kv)
    return out


def greedy_step(decode, params, caches, tokens, pos: int, *,
                graph: bool | None = None) -> steps.GraphedStep:
    """``decode(params, tokens, caches, pos) -> (logits, caches)`` and the
    greedy argmax as one ``steps.GraphedStep`` over fixed token and
    position buffers (copies of ``tokens`` and of ``pos`` as a 0-d device
    tensor), the caches written in place: on a card a CUDA graph unless
    ``graph`` is ``False`` (a step on a mesh is given ``False``, the answer
    ``steps.use_graph`` gives for it).  Its one output is the next tokens
    (b, 1) int32."""
    def step(caches, tokens, pos):
        out, _ = decode(params, tokens, caches, pos)
        return torch.argmax(full(out)[:, -1], dim=-1)[:, None].to(torch.int32)

    return steps.GraphedStep(
        step, caches, {"tokens": tokens, "pos": torch.full(
            (), pos, dtype=torch.long, device=tokens.device)},
        graph=graph)


def decode_loop(decode, params, caches, first_tok, prompt_len: int,
                max_new: int, *, graph: bool | None = None):
    """Greedy decode: ``max_new`` tokens total — the prefill's argmax plus
    ``max_new - 1`` decode steps, every step's logits consumed.

    The steps run as one ``greedy_step``: on a card a CUDA graph, captured
    at the second step and replayed from there (``graph=False``, as a mesh
    is given, runs every step eagerly).  Before each step the last step's
    token is copied into the token buffer and the position filled in on
    the device; each step's token is cloned out of the fixed output
    buffer.  Tokens stay **on the device** and are fetched with a single
    host transfer at the end, so the host never waits on a step.

    Returns ``(generations (b, max_new) int32, caches, decode_steps)``.
    """
    b = first_tok.shape[0]
    if max_new <= 0:
        return np.zeros((b, 0), np.int32), caches, 0
    outs = [first_tok]
    if max_new > 1:
        run = greedy_step(decode, params, caches, first_tok, prompt_len,
                          graph=graph)
        for i in range(max_new - 1):
            if i:
                run.inputs["tokens"].copy_(outs[-1])
                run.inputs["pos"].fill_(prompt_len + i)
            outs.append(run()[0].clone())
    return torch.cat(outs, dim=1).cpu().numpy(), caches, max_new - 1


def serve(cfg, prompts: np.ndarray, *, max_new: int = 32, mesh=None,
          kv_len: int | None = None, params=None, seed: int = 0,
          plan_cache=None, device=None, executor: str = "gspmd",
          graph: bool | None = None):
    """prompts: (b, prompt_len) int32.  Returns (generations (b, max_new),
    stats).

    ``device`` defaults to the card; with no card and no explicit device
    this raises.  ``params`` defaults to seeded random weights made on the
    device.  ``plan_cache`` is a ``core.plancache.PlanCache`` or a path to
    its JSON store: the planner warm-starts from it (a structurally
    identical graph planned by any earlier process, by this package or the
    JAX one, is a cache hit that skips the §8 DP) and persists the plan it
    used.

    ``executor`` selects how the cell's Program realizes its plan
    (``engine.EXECUTORS``); with ``"shard_map"`` the compiled program's
    static collective schedule is printed.

    ``mesh`` (a ``launch.mesh.Mesh``, default the one-device mesh): on more
    than one rank every rank of the process group calls ``serve`` with the
    same prompts; the plan is made on the mesh's axes, the weights (seeded,
    or ``params`` given whole) are placed by ``param_shardings``, and every
    rank returns the whole generations.  ``stats["param_bytes"]`` is this
    rank's share of the weights.

    ``graph``: the decode step and its greedy argmax replay one CUDA graph
    per step on a card with no mesh (``decode_loop``, ``steps.use_graph``:
    the reference jits its decode step and donates the caches); ``False``
    decodes eagerly, ``True`` raises where no graph can be captured (the
    CPU, a mesh of more than one rank).  The prefill runs eagerly.
    """
    placed = mesh is not None and mesh.world_size > 1
    dev = mesh.device if mesh is not None else resolve_device(device)
    graph = steps.use_graph(graph, dev, mesh)  # raises before any work
    b, prompt_len = prompts.shape
    kv_len = kv_len or (cfg.kv_len(ShapeConfig("serve", "decode",
                                               prompt_len + max_new, b)))
    shape = ShapeConfig("serve", "prefill", prompt_len, b)
    # declare -> trace -> decompose (through the plan cache) -> project
    t0 = time.perf_counter()
    if mesh is None and executor == "shard_map":
        mesh = Mesh(ONE_DEVICE_MESH, device=dev)
    axes = dict(mesh.sizes) if mesh is not None else dict(ONE_DEVICE_MESH)
    compiled = program_for(cfg, shape).compile(
        mesh_axes=axes, cache=PlanCache.coerce(plan_cache),
        mesh=mesh if executor == "shard_map" else None, executor=executor,
        device=dev)
    policy = compiled.policy()
    if compiled.collectives is not None:
        print(f"[serve] shard_map executor schedule for {cfg.name}:")
        print(compiled.collectives.summary())
    t_plan = time.perf_counter() - t0

    if not placed:
        mesh = None
    if params is None:
        params = (tf.init_placed_params(cfg, policy, mesh, seed=seed) if placed
                  else tf.init_params(cfg, seed=seed, device=dev))
    else:
        params = tf.place_params(params, cfg, policy, mesh)
    prefill = steps.make_prefill_step(cfg, policy=policy, mesh=mesh)
    serve_step = steps.make_serve_step(cfg, policy=policy, mesh=mesh)

    # DTensor views cannot be made of inference tensors: no_grad on a mesh
    with torch.no_grad() if placed else torch.inference_mode():
        tokens = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens})
        logits = full(logits)
        caches = prepare_decode_caches(cfg, caches, prompt_len, kv_len,
                                       policy=policy, mesh=mesh)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        t0 = time.perf_counter()
        gen, caches, decode_steps = decode_loop(serve_step, params, caches,
                                                tok, prompt_len, max_new,
                                                graph=graph)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return gen, {"device": str(dev), "t_plan_s": t_plan,
                 "t_prefill_s": t_prefill, "t_decode_s": t_decode,
                 "decode_steps": decode_steps, "graph": graph,
                 "tok_per_s": b * decode_steps / max(t_decode, 1e-9),
                 "plan_cost": compiled.plan.cost,
                 "policy": dict(policy.label_axes),
                 "param_bytes": _local_bytes(params)}


def _local_bytes(params) -> int:
    """Bytes of this rank's blocks of the weights."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in tree.leaves(params))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--plan-cache", default=None,
                    help="path to a persistent plan-cache JSON store; "
                         "warm-starts the planner across restarts")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--executor", default="gspmd",
                    choices=["gspmd", "shard_map"],
                    help="plan realization; shard_map prints the compiled "
                         "program's static collective schedule")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (repro_torch.serving): "
                         "slot scheduler + paged KV pool + bucket registry; "
                         "prompts get mixed lengths around --prompt-len")
    ap.add_argument("--requests", type=int, default=8,
                    help="[--continuous] number of requests to submit")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="[--continuous] KV pool block size (cache rows)")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="[--continuous] per-request capacity ceiling "
                         "(prompt+generated); default prompt-len + max-new")
    ap.add_argument("--bucket", default="auto",
                    choices=["auto", "pow2", "exact"],
                    help="[--continuous] prefill bucket policy: pow2 "
                         "rounding for pad-free archs under 'auto'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rng = np.random.default_rng(0)

    if args.continuous:
        from repro_torch.serving import ServingEngine

        max_seq = args.max_seq or (args.prompt_len + args.max_new)
        eng = ServingEngine(cfg, batch=args.batch, max_seq=max_seq,
                            block=args.kv_block, plan_cache=args.plan_cache,
                            bucket=args.bucket, device=args.device)
        for _ in range(args.requests):
            plen = int(rng.integers(max(1, args.prompt_len // 2),
                                    args.prompt_len + 1))
            eng.submit(rng.integers(0, cfg.vocab, size=(plen,)), args.max_new)
        results, metrics = eng.run()
        for rid in sorted(results):
            print(f"request {rid}: {results[rid]}")
        print(metrics.summary())
        print(eng.registry.stats)
        return
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    gen, stats = serve(cfg, prompts, max_new=args.max_new,
                       plan_cache=args.plan_cache, device=args.device,
                       executor=args.executor)
    print("generations:\n", gen)
    print(stats)


if __name__ == "__main__":
    main()
