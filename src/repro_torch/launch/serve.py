"""Serving driver: batched prefill + greedy decode loop with KV caches.

``serve`` declares the cell's model graph, plans it through the plan cache
(the paper's pipeline: ``program_for`` -> ``Program.compile`` -> §8 DP or a
cache hit -> ``policy()``), then prefills the batch of prompts in one
forward (one flash-attention kernel launch per layer on a card), copies the
collected K/V into preallocated decode caches and decodes greedily, writing
each step's K/V into those caches in place.  Sliding-window archs keep
ring-buffer caches.

The explicit-collective executor (``--executor shard_map``) and the
continuous-batching engine (``--continuous``) of the reference are not
ported yet.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plancache import PlanCache
from repro_torch.launch import steps
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


def prepare_decode_caches(cfg, prefill_caches, prompt_len: int, kv_len: int):
    """Convert prefill-collected caches into decode-ready buffers: the
    preallocated (units, b, kv_len, kv_heads, hd) caches of
    ``tf.init_caches`` holding the prompt's K/V (ring order for windowed
    archs)."""
    k0 = prefill_caches[0][0]
    if cfg.window:
        return [_ring_pack(KVCache(k, v), prompt_len, kv_len)
                for k, v in prefill_caches]
    out = tf.init_caches(cfg, k0.shape[1], kv_len, device=k0.device)
    for cache, (k, v) in zip(out, prefill_caches):
        cache.k[:, :, :prompt_len] = k
        cache.v[:, :, :prompt_len] = v
    return out


def decode_loop(decode, params, caches, first_tok, prompt_len: int,
                max_new: int):
    """Greedy decode: ``max_new`` tokens total — the prefill's argmax plus
    ``max_new - 1`` decode steps, every step's logits consumed.

    Tokens stay **on the device** and are fetched with a single host
    transfer at the end, so the host never waits on a step; the next step
    reads the greedy argmax from device memory.

    Returns ``(generations (b, max_new) int32, caches, decode_steps)``.
    """
    b = first_tok.shape[0]
    if max_new <= 0:
        return np.zeros((b, 0), np.int32), caches, 0
    outs = [first_tok]
    tok = first_tok
    n_steps = 0
    for i in range(max_new - 1):
        logits, caches = decode(params, tok, caches, prompt_len + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        outs.append(tok)
        n_steps += 1
    return torch.cat(outs, dim=1).cpu().numpy(), caches, n_steps


def serve(cfg, prompts: np.ndarray, *, max_new: int = 32,
          kv_len: int | None = None, params=None, seed: int = 0,
          plan_cache=None, device=None):
    """prompts: (b, prompt_len) int32.  Returns (generations (b, max_new),
    stats).

    ``device`` defaults to the card; with no card and no explicit device
    this raises.  ``params`` defaults to seeded random weights made on the
    device.  ``plan_cache`` is a ``core.plancache.PlanCache`` or a path to
    its JSON store: the planner warm-starts from it (a structurally
    identical graph planned by any earlier process, by this package or the
    JAX one, is a cache hit that skips the §8 DP) and persists the plan it
    used.
    """
    dev = resolve_device(device)
    b, prompt_len = prompts.shape
    kv_len = kv_len or (cfg.kv_len(ShapeConfig("serve", "decode",
                                               prompt_len + max_new, b)))
    shape = ShapeConfig("serve", "prefill", prompt_len, b)
    # declare -> trace -> decompose (through the plan cache) -> project
    t0 = time.perf_counter()
    compiled = program_for(cfg, shape).compile(
        mesh_axes=dict(ONE_DEVICE_MESH), cache=PlanCache.coerce(plan_cache))
    policy = compiled.policy()
    t_plan = time.perf_counter() - t0

    if params is None:
        params = tf.init_params(cfg, seed=seed, device=dev)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_serve_step(cfg)

    with torch.inference_mode():
        tokens = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens})
        caches = prepare_decode_caches(cfg, caches, prompt_len, kv_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        t0 = time.perf_counter()
        gen, caches, decode_steps = decode_loop(decode, params, caches, tok,
                                                prompt_len, max_new)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return gen, {"device": str(dev), "t_plan_s": t_plan,
                 "t_prefill_s": t_prefill, "t_decode_s": t_decode,
                 "decode_steps": decode_steps,
                 "tok_per_s": b * decode_steps / max(t_decode, 1e-9),
                 "plan_cost": compiled.plan.cost,
                 "policy": dict(policy.label_axes)}


def main() -> None:
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
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    gen, stats = serve(cfg, prompts, max_new=args.max_new,
                       plan_cache=args.plan_cache, device=args.device)
    print("generations:\n", gen)
    print(stats)


if __name__ == "__main__":
    main()
