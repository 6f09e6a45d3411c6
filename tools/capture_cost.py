"""What a CUDA graph's capture costs against the eager call and the replay
it buys, for the serving engine's bucket prefill with its admission and
for a dense prefill, on one card.

    python tools/capture_cost.py [--arch llama-7b] [--out FILE]

The engine's step is ``ServingEngine._compiled_prefill``'s (prefill,
argmax, admission into the paged pool), at batch 1 over two buckets of
the arch (pow2: 512 and 256; prompts 465 and 205); the dense step is
``steps.make_prefill_step`` at b=4, 512 tokens.  For each step:

* ``eager_ms``: the step called on the main stream, ending in a
  synchronize (median of 5, after one warm call);
* a capture split in its parts, done as ``GraphedStep._capture`` does
  it (``steps.side_stream``, ``capture_begin(pool=)``, no synchronize and
  no emptying of the caches): ``fn_ms`` the step's Python under capture,
  ``end_ms`` ``capture_end`` (the graph's instantiation), ``first_ms``
  the first replay, ending in a synchronize, ``replay_ms`` the median
  of 5 later replays; ``segments`` the device segments the allocator
  made (cudaMalloc) during the capture, ``nodes`` the kernels the step
  launches eagerly (the trace's count of one call is not taken: the
  counters of ``kernels.ops`` count only the port's kernels);
* the same capture again into the same pool (``warm pool``), and once
  through ``torch.cuda.graph`` (which synchronizes and empties the
  device and pinned host caches first) into a pool of its own.

Prints one JSON object (also written to ``--out``) with the card's name
and power limit.  Random weights from seed 0, bf16, full width and
depth.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _segments() -> int:
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def _capture_parts(fn, outputs, pool, *, torch_graph: bool = False) -> dict:
    """Capture ``fn`` (whose results are copied into ``outputs``) and
    replay it, timing each part.  The graph is returned too: a pool shared
    by graphs lives while one of them does."""
    from repro_torch.launch.steps import side_stream

    graph = torch.cuda.CUDAGraph()
    seg0 = _segments()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if torch_graph:
        with torch.cuda.graph(graph, pool=pool):
            for fixed, o in zip(outputs, fn()):
                fixed.copy_(o)
        t1 = t2 = time.perf_counter()
    else:
        side = side_stream(torch.cuda.current_device())
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            for fixed, o in zip(outputs, fn()):
                fixed.copy_(o)
            t1 = time.perf_counter()
            graph.capture_end()
        t2 = time.perf_counter()
    first = _sync_ms(graph.replay)
    replays = [_sync_ms(graph.replay) for _ in range(5)]
    return {"fn_ms": 1e3 * (t1 - t0), "end_ms": 1e3 * (t2 - t1), "first_ms": first,
            "replay_ms": statistics.median(replays), "segments": _segments() - seg0,
            "graph": graph}


_GRAPHS: list = []  # every graph kept to the end, and with it the shared pool


def _case(name: str, fn, pool) -> dict:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    nodes = sum(1 for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    fn()
    eager = statistics.median(_sync_ms(fn) for _ in range(5))
    outputs = tuple(o.clone() for o in fn())
    out = {"eager_ms": eager, "nodes": nodes}
    cold = _capture_parts(fn, outputs, pool)
    warm = _capture_parts(fn, outputs, pool)
    torch_way = _capture_parts(fn, outputs, None, torch_graph=True)
    for key, res in (("capture", cold), ("capture_warm_pool", warm),
                     ("capture_torch_graph", torch_way)):
        _GRAPHS.append(res.pop("graph"))
        out[key] = res
    print(f"{name}: {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    cfg = get_config(args.arch)
    params = tf.init_params(cfg, seed=0, device="cuda")
    eng = ServingEngine(cfg, batch=4, max_seq=528, block=16, params=params, device="cuda",
                        graph=False)
    rng = np.random.default_rng(0)
    res = {"card": card.strip(), "arch": cfg.name}
    pool = torch.cuda.graph_pool_handle()
    with torch.inference_mode():
        for plen in (465, 205):
            ent = eng.registry.prefill(plen)
            step = eng._compiled_prefill(ent)  # its fn and fixed inputs, run by hand
            toks = np.zeros((1, ent.key[2]), np.int32)
            toks[0, :plen] = rng.integers(0, cfg.vocab, size=plen)
            step.inputs["tokens"].copy_(torch.from_numpy(toks))
            step.inputs["last_index"].fill_(plen - 1)
            step.inputs["blocks"].copy_(torch.arange(1, eng.W + 1, dtype=torch.int32))
            res[f"bucket_{ent.key[2]}"] = _case(
                f"engine bucket {ent.key[2]} (prompt {plen})",
                lambda: step.fn(step.state, **step.inputs), pool)
        prefill = steps.make_prefill_step(cfg)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 512)).astype(np.int32),
                                 device="cuda")
        res["dense_b4_512"] = _case("dense prefill b=4, 512",
                                    lambda: (prefill(params, {"tokens": tokens})[0],),
                                    torch.cuda.graph_pool_handle())
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
