"""Training driver: the training loop with checkpoint/restart,
deterministic data replay and async checkpointing, on one device or on a
mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-7b \\
        --reduced --steps 2 --seq 32 --batch 2 --device cpu

It runs on the card unless ``--device`` says otherwise (and raises where
there is no card).  The step is planned as the reference plans it: the
cell's Program goes through the plan cache on the one-device mesh and its
plan is projected to the ShardingPolicy the model stack reads (its remat
choice among it).  The step itself differentiates the model stack with
``torch.autograd``: flash attention runs through the kernel, whose
backward is the plain version's.

Configs with a prefix (paligemma's patch embeddings, a stub of the
vision tower) get float32 normal prefix embeddings drawn from
``default_rng(step)``, as in the reference; the model casts them.

Fault tolerance, as in the reference: checkpoints carry {params,
opt_state} and the step; restore reshards onto whatever mesh the restarted
job has (elastic: the planner plans for the new mesh); the data pipeline
is counter-based, so step N's batch is the same across restarts;
checkpoint writes run on a background thread.  On a ``launch.mesh.Mesh``
of more than one rank (``train(mesh=)`` in every rank of the process
group) the weights and AdamW moments are placed by
``transformer.param_shardings``, the batch by ``batch_shardings``, and the
step pins each gradient to its parameter's placements
(``steps.make_train_step``); under ``executor="gspmd"`` the cell's Program
is compiled on that mesh.  Its checkpoints are written by rank 0 from
leaves gathered leaf by leaf, and each rank restores its own blocks
(``checkpoint/ckpt.py``).  ``--mesh data=2`` runs the CLI on a mesh of
gloo ranks it spawns, one process a rank (sharing the card, or on the CPU
with ``--device cpu``); a checkpoint it writes restarts on any mesh:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-7b \\
        --reduced --steps 4 --seq 32 --batch 2 --mesh data=2 \\
        --ckpt /tmp/ckpt --device cpu

``--pp > 1`` prints the static pipeline summary of the forward program
(stages, bubble, handoff wire); the step itself runs the unpipelined plan,
as in the reference.

The step is compiled as the reference jits it with the parameters and
moments donated: on a card with no mesh it replays one CUDA graph
(``steps.GraphedStep``: the first step eager, the second captured, every
later step a replay), the batch copied into fixed device buffers, the
parameters, moments and step counter written in place, the metrics read
from fixed output buffers after each step.  ``train(graph=False)`` runs
it eagerly; the CPU and a mesh of more than one rank always do, through
the same buffers.  A checkpoint saves the tensors the graph writes; a
restore makes the step after it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plancache import PlanCache
from repro_torch.data.synthetic import SyntheticLM, place_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.serve import ONE_DEVICE_MESH
from repro_torch.models import transformer as tf
from repro_torch.models.common import resolve_device
from repro_torch.models.eingraphs import fsdp_axes_for, program_for
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, shape: ShapeConfig, *, steps_total: int = 100,
          mesh=None, ckpt_dir: str | None = None, ckpt_every: int = 50,
          schedule: str = "cosine", peak_lr: float = 3e-4,
          log_every: int = 10, seed: int = 0, plan_cache=None,
          executor: str = "gspmd", pp: int = 1, microbatches: int = 1,
          device=None, graph: bool | None = None) -> dict:
    """Train ``cfg`` for ``steps_total`` steps on batches of ``shape``.

    Returns ``{"history": [(step, loss) every log_every steps and at the
    end], "steps": [per step: step, loss, ce, grad_norm, lr, wall_s],
    "params", "opt_state", "replays"}``; ``wall_s`` is the step's host time
    ending in a synchronize, ``replays`` how many steps replayed the
    compiled step's CUDA graph (0 where it runs eagerly).  ``device``
    defaults to the card (``mesh.device`` where a mesh is given); the
    weights are seeded random ones made there.
    ``plan_cache`` is a ``PlanCache`` or a path to its JSON store.  With
    ``pp > 1`` the static pipeline summary over ``pp`` stages and
    ``microbatches`` is printed first.

    With ``ckpt_dir`` the run saves {params, opt_state} every
    ``ckpt_every`` steps and at its end, and starts from the latest
    checkpoint there, on whatever mesh this run has: each rank reads its
    blocks of the files onto this run's placements, and no weights are
    made first.  The AdamW moments are restored under the parameters'
    placements: the reference restores them unplaced and lets ``jit``
    place them, but in the port a plain tensor cannot meet a DTensor in
    the step.

    ``graph`` is ``steps.use_graph``'s: ``None`` replays the step as a
    CUDA graph on a card with no mesh of more than one rank and runs it
    eagerly elsewhere, ``False`` runs it eagerly, ``True`` asks for the
    graph and raises where there is none (the module docstring)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    mesh = mesh or Mesh(ONE_DEVICE_MESH, device=dev)
    axes = dict(mesh.sizes)
    placed = mesh.world_size > 1
    graph = steps.use_graph(graph, dev, mesh)
    if pp > 1:
        _print_pipeline_summary(cfg, shape, axes, pp, microbatches)
    # warm-start planning from the persistent cache: on restart the §8 DP
    # is a cache hit instead of a re-run
    compiled = program_for(cfg, shape).compile(
        mesh_axes=axes, cache=PlanCache.coerce(plan_cache),
        mesh=mesh if executor == "shard_map" or placed else None,
        executor=executor, device=dev)
    policy = compiled.policy(fsdp_axes=fsdp_axes_for(axes))
    if compiled.collectives is not None:
        print(f"[train] shard_map executor schedule for {cfg.name}:")
        print(compiled.collectives.summary())

    if schedule == "wsd":
        def lr_fn(s):
            return wsd_schedule(s, peak_lr=peak_lr,
                                warmup=max(steps_total // 10, 1),
                                stable=steps_total // 2,
                                decay=max(steps_total // 5, 1))
    else:
        def lr_fn(s):
            return cosine_schedule(s, peak_lr=peak_lr,
                                   warmup=max(steps_total // 10, 1),
                                   total=steps_total)

    step_fn = steps.make_train_step(cfg, policy=policy, mesh=mesh, lr_fn=lr_fn)
    data = SyntheticLM(cfg.vocab, shape.seq - cfg.prefix_len, shape.batch,
                       seed=seed)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start, restored = 0, None
    if mgr is not None:
        # each rank reads its blocks straight onto this run's placements; the
        # tree it restores into is a structure on the meta device, so no
        # weights are made only to be replaced
        pspecs = tf.param_specs(cfg, policy, mesh)
        meta = tf.init_params(cfg, device="meta")
        step0 = torch.zeros((), dtype=torch.int32, device=dev)
        restored = mgr.restore_latest(
            (meta, AdamWState(step0, meta, meta)),
            shardings=(pspecs, AdamWState(None, pspecs, pspecs)), mesh=mesh)
    if restored is not None:
        start, (params, opt_state), _ = restored
        print(f"[train] restored step {start} (elastic reshard onto {axes})")
    else:
        params = tf.init_placed_params(cfg, policy, mesh, seed=seed)
        opt_state = adamw_init(params)

    history, per_step = [], []
    run = None  # the compiled step, made at the first step (after a restore)
    t0 = time.time()
    for step in range(start, steps_total):
        hb = data.global_batch_at(step)
        host = {k: hb[k] for k in ("tokens", "labels")}
        if cfg.prefix_len:  # the stubbed frontend's embeddings, step-seeded
            host["prefix_embeds"] = np.random.default_rng(step).normal(
                size=(shape.batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        batch = place_batch(host, policy, mesh)
        if run is None:
            run = compiled_train_step(step_fn, params, opt_state, batch, graph=graph)
        else:
            for k, v in batch.items():
                run.inputs[k].copy_(v)
        _sync(dev)
        ts = time.perf_counter()
        metrics = dict(zip(METRICS, run()))
        _sync(dev)
        wall = time.perf_counter() - ts
        loss = float(metrics["loss"])
        per_step.append({"step": step, "loss": loss,
                         "ce": float(metrics["ce"]),
                         "grad_norm": float(metrics["grad_norm"]),
                         "lr": float(metrics["lr"]), "wall_s": wall})
        if step % log_every == 0 or step == steps_total - 1:
            history.append((step, loss))
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, (params, opt_state))
    if mgr is not None:
        mgr.save(steps_total, (params, opt_state), blocking=True)
    return {"history": history, "steps": per_step, "params": params,
            "opt_state": opt_state, "replays": run.replays if run is not None else 0}


#: the train step's metrics, in the order of the compiled step's outputs
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def compiled_train_step(step_fn, params, opt_state, batch: dict, *,
                        graph: bool | None = None) -> steps.GraphedStep:
    """``step_fn`` (``steps.make_train_step``'s) as a ``GraphedStep``: the
    state is ``(params, opt_state)``, written in place; the inputs are
    fixed copies of ``batch``'s entries, which the caller ``copy_``s the
    next batch into; each call returns the ``METRICS`` as 0-d tensors in
    fixed output buffers."""
    def fn(state, **batch):
        _, _, metrics = step_fn(*state, batch)
        return tuple(metrics[k] for k in METRICS)

    return steps.GraphedStep(fn, (params, opt_state), batch, graph=graph)


def _print_pipeline_summary(cfg, shape: ShapeConfig, intra_axes: dict,
                            pp: int, microbatches: int) -> None:
    """Static pipeline report for the forward program: partition the graph
    into ``pp`` stages over a combined (pp, intra) mesh, price the GPipe
    bubble and handoff wire, and print the fill/drain summary.  The
    training step itself still runs the unpipelined plan — 1F1B grad-path
    pipelining is the pipeline tier's documented stretch goal."""
    from repro_torch.pipeline import PipelineSpec, build_pipeline_schedule

    prog = program_for(cfg, shape)
    combined = {"pp": pp, **intra_axes}
    psched = build_pipeline_schedule(
        prog.graph, PipelineSpec(stages=pp, microbatches=microbatches),
        combined, [prog._out[k] for k in prog._out])
    cut_b = sum(psched.cut_elems) * 4
    print(f"[train] pipeline (static): p={pp} m={psched.spec.microbatches} "
          f"bubble={psched.bubble:.3f} "
          f"(weighted {psched.bubble_weighted:.3f}) "
          f"cut={cut_b:,}B handoff={psched.handoff_elems:,} elems")
    for st in psched.stages:
        print(f"[train]   stage {st.index}: {len(st.nids)} nodes, "
              f"recv {len(st.recv)} tensors")
    print("[train] note: the optimizer step runs the unpipelined plan "
          "(1F1B grad pipelining is the tier's stretch goal)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--plan-cache", default=None,
                    help="path to a persistent plan-cache JSON store; "
                         "warm-starts the planner across restarts")
    ap.add_argument("--executor", default="gspmd",
                    choices=["gspmd", "shard_map"],
                    help="plan realization; shard_map prints the compiled "
                         "program's static collective schedule")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: with --pp > 1, partition the "
                         "forward graph over a pp mesh axis and print the "
                         "static GPipe schedule (bubble, cut bytes, "
                         "handoff wire) before training")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="GPipe microbatches per step for the --pp summary "
                         "(must divide --batch)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    ap.add_argument("--mesh", default=None,
                    help="train on a mesh of gloo ranks spawned here, one "
                         "process a rank, e.g. data=2 or data=1,model=2")
    args = ap.parse_args(argv)
    if args.mesh:
        import math
        import tempfile

        from repro_torch.launch.mesh import spawn

        sizes = {a: int(n) for a, n in
                 (kv.split("=") for kv in args.mesh.split(","))}
        with tempfile.TemporaryDirectory() as tmp:
            spawn(math.prod(sizes.values()), _mesh_main, args, sizes,
                  tmpdir=tmp, timeout=7 * 24 * 3600.0)
        return
    _run(args)


def _run(args, mesh=None) -> None:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    train(cfg, shape, steps_total=args.steps, mesh=mesh, ckpt_dir=args.ckpt,
          schedule=args.schedule, plan_cache=args.plan_cache,
          executor=args.executor, pp=args.pp,
          microbatches=args.microbatches, device=args.device)


def _mesh_main(rank: int, world: int, args, sizes: dict) -> None:
    """One rank of ``--mesh``: rank 0 prints, the others are quiet."""
    import contextlib
    import os
    import sys

    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(sys.stdout if rank == 0 else null):
        _run(args, Mesh(sizes, device=args.device))


if __name__ == "__main__":
    main()
