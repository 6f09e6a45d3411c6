"""Multi-pod dry run: every (architecture x input-shape) cell planned on
the production mesh and run abstractly, in one process, with no card.

For every cell and mesh:

  1. run EinDecomp on the cell's EinGraph -> ShardingPolicy (``_plan_cell``),
  2. build abstract params / optimizer / caches / batch (``build_cell``):
     DTensors on an abstract mesh — this process is rank 0 of a process
     group of 256 or 512 ranks on torch's ``"fake"`` backend
     (``launch.mesh.init_fake_process_group``, ``Mesh(abstract=True)``) —
     whose local blocks are meta tensors of the rank's block shape, which
     stand for blocks on the rank's card: no allocation, no generator, no
     card.  (Not fake CUDA tensors: the Python bindings of indexing,
     ``.contiguous()`` and ``.copy_()`` set a device guard from the
     tensor's device, which fails on a machine with no card.)
  3. run the production step (``launch/steps.py``) on them as rank 0: the
     counterpart of the reference's lower-and-compile.  It runs through,
     so the plan is coherent on the mesh; ``launch.costs.StepCosts`` over
     it gives the rank's memory, FLOPs, bytes and collective wire bytes
     (``launch/hlo_analysis.py``).  The kernels' entry points are custom
     ops that fake tensors pass through (``kernels/ops.py``); their calls
     by design are the launches a rank would make (``kernel_calls``),
  4. extract roofline terms.

Where the port differs from the reference:

  * No unrolled variants.  Eager execution runs every layer and every time
    step, so one abstract run counts the whole depth, inner time loops
    included: ``inner_scan_flops_corr_per_dev`` is 0 (``inner_scan_correction``
    is kept verbatim, and tested).
  * Trip counting, for the train and prefill cells of an all-recurrent
    model (xLSTM: every block an mLSTM or an sLSTM, no attention).  Its
    sLSTM loop is a Python loop over positions, and at about 1 ms an op on
    meta blocks 4,096 positions of it would take half an hour; but every
    trip of it, and every 256-position chunk of the mLSTM, is the same
    fixed-shape body, and nothing else in such a step depends on the
    length but linearly.  So the step's FLOPs, bytes, collectives and live
    memory are affine in the length over whole chunks — from two chunks on
    for a train step, whose first and last chunks' backward differ from the
    middle ones' (the first reads a state with no gradient, the last's
    state feeds nothing).  ``run_abstract`` runs such a cell at two short
    lengths (``TRIP_LENGTHS``) and extends each count along the line
    through them; the record says so (``trip_counted``), and
    ``tests/test_torch_dryrun.py`` holds the extension equal to a full run
    at a longer length.
  * The constants are an H100's (NVIDIA H100 80GB HBM3, SXM, at its 700 W
    power limit; NVIDIA's data sheet): ``PEAK_FLOPS`` 989e12 (bf16 dense),
    ``HBM_BW`` 3.35e12 B/s, and ``NVLINK_BW`` 450e9 B/s — NVLink 4, each
    way — in place of ``ICI_BW``.  An axis of 16 cards spans two 8-card
    NVLink nodes, whose link between them is slower, so ``t_collective_s``
    is a lower bound.  ``HBM_BYTES`` is the card's memory as
    ``torch.cuda.get_device_properties(0).total_memory`` reads it
    (``chip_smoke.py`` phase 32); the dry run itself never queries CUDA.
  * ``fits_16gb`` (a TPU v5e's HBM) becomes ``fits_80gb``:
    ``per_device_gb`` against ``HBM_BYTES``.
  * ``alias_gb`` is 0: the port updates parameters, moments and caches in
    place, so an updated buffer is counted once, as an argument, and no
    output aliases an argument.  ``temp_gb`` is what the peak of live
    bytes held beyond the arguments and the outputs.
  * ``compile_s`` is the wall of the abstract run.
  * ``--all`` covers ``ARCH_IDS`` and llama-7b, the port's first model,
    every block kind included: the MoE cells route each rank's own tokens,
    move the kept rows to their experts' ranks by all-to-all where the
    batch and the experts share mesh axes (an abstract run's counts have
    no values, so its all-to-alls carry an even routing's rows:
    ``models/moe._even_counts``), and run the expert products on each
    rank's expert block;
    the hymba and xLSTM cells run their recurrences on each rank's batch
    rows (the xLSTM's train and prefill cells trip counted, above).

Usage:
  python -m repro_torch.launch.dryrun --arch llama-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod]
Records land in artifacts/dryrun_torch/*.json (the reference's
artifacts/dryrun is left alone).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import math
import os
import time
import traceback

import torch

# NVIDIA H100 80GB HBM3 (SXM) at a 700 W power limit: the TARGET hardware
DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way (NVLink 4)
HBM_BYTES = 85_017_493_504   # total_memory of that card (chip_smoke phase 32)


# process-wide plan cache for the dry-run sweep: isomorphic cells (same
# block structure at the same bounds and mesh) plan once across the whole
# --all matrix, exactly like a disk-backed cache would across jobs.
_PLAN_CACHE = None
_MESHES: dict = {}


def _plan_cell(cfg, shape, axes, fsdp):
    """EinDecomp one cell through the Program surface -> (plan, policy)."""
    from repro_torch.core.plancache import PlanCache
    from repro_torch.models.eingraphs import fsdp_axes_for, program_for

    global _PLAN_CACHE
    if _PLAN_CACHE is None:
        _PLAN_CACHE = PlanCache(capacity=128)
    compiled = program_for(cfg, shape).compile(mesh_axes=axes,
                                               cache=_PLAN_CACHE)
    policy = compiled.policy(fsdp_axes=fsdp_axes_for(axes) if fsdp else ())
    return compiled.plan, policy


def abstract_mesh(shape=(16, 16), axes=("data", "model"), *, device="meta"):
    """An abstract ``Mesh`` of ``shape`` over ``axes`` (``Mesh(abstract=
    True)``): this process as rank 0 of a fake process group of that many
    ranks, which a mesh of another size re-initialises; made once per
    group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_fake_process_group, make_mesh

    world = math.prod(shape)
    if world > 1 and not (dist.is_initialized() and dist.get_world_size() == world):
        _MESHES.clear()  # their groups go with the old process group
        init_fake_process_group(world)
    key = (tuple(shape), tuple(axes), str(device))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(shape, axes, device=device, abstract=True)
    return _MESHES[key]


def production_mesh(multi_pod: bool = False):
    """The abstract production mesh: (16, 16) or (2, 16, 16)."""
    from repro_torch.launch.mesh import PRODUCTION_MESHES

    return abstract_mesh(*PRODUCTION_MESHES[bool(multi_pod)])


def _block_shape(shape, placements, mesh) -> tuple:
    """This rank's block of a tensor of ``shape`` under ``placements``."""
    out = list(shape)
    for name, p in zip(mesh.axis_names, placements or ()):
        if p.is_shard():
            out[p.dim] //= mesh.sizes[name]
    return tuple(out)


def _leaf(shape, dtype, placements, mesh):
    """A zero tensor of ``shape`` placed on ``mesh``: a DTensor of this
    rank's block on a mesh of more than one rank, the whole tensor on one,
    made on ``mesh.device``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.gspmd import _contiguous_stride

    if mesh.world_size == 1 or placements is None:
        return torch.zeros(shape, dtype=dtype, device=mesh.device)
    local = torch.zeros(_block_shape(shape, placements, mesh), dtype=dtype,
                        device=mesh.device)
    return DTensor.from_local(local, mesh.dmesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def build_cell(cfg, shape, mesh, *, fsdp: bool | None = None,
               policy_override=None, abstract: bool = True):
    """(step_fn, example_args, donate, plan, policy).  The arguments are
    zero tensors of the cell's shapes, made without a generator and placed
    as the policy says (``param_shardings``, ``cache_shardings``,
    ``batch_shardings``; the AdamW moments carry the parameters'
    placements), on ``mesh.device``: meta blocks on an abstract mesh of the
    default device; with ``abstract`` on another device, fake tensors of a
    ``FakeTensorMode`` of their own (``measure_step`` runs the step under
    it); else real tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.synthetic import batch_shardings
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import mesh_axes_dict
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    axes = mesh_axes_dict(mesh)
    if fsdp is None:
        fsdp = shape.kind == "train"
    if policy_override is not None:
        policy, plan = policy_override, None
    else:
        plan, policy = _plan_cell(cfg, shape, axes, fsdp)

    def placed(tree, shardings):
        return tf._zip_map(lambda t, pl: _leaf(tuple(t.shape), t.dtype, pl, mesh),
                           tree, shardings)

    fake = abstract and mesh.device.type != "meta"  # meta blocks need no mode
    with FakeTensorMode() if fake else contextlib.nullcontext():
        params = placed(tf.init_params(cfg, device="meta"),
                        tf.param_shardings(cfg, policy, mesh))
        specs = tf.input_specs(cfg, shape)
        bshard = batch_shardings(policy, mesh, {k: v.shape for k, v in specs.items()})
        batch = {k: _leaf(v.shape, v.dtype, bshard[k], mesh)
                 for k, v in specs.items() if k != "pos"}
        if shape.kind == "train":
            opt = adamw_init(params)  # zeros_like: the parameters' placements
        elif shape.kind == "decode":
            kv_len = cfg.kv_len(shape)
            caches = placed(tf.init_caches(cfg, shape.batch, kv_len, device="meta"),
                            tf.cache_shardings(cfg, shape.batch, kv_len, policy, mesh))
    if shape.kind == "train":
        step = steps.make_train_step(cfg, policy=policy, mesh=mesh)
        return step, (params, opt, batch), (0, 1), plan, policy
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, policy=policy, mesh=mesh)
        return step, (params, batch), (), plan, policy
    step = steps.make_serve_step(cfg, policy=policy, mesh=mesh)
    return step, (params, batch["tokens"], caches, kv_len - 1), (2,), plan, policy


def measure_step(step, args, tag_buffers: bool = False) -> dict:
    """Run ``step(*args)`` once under ``launch.costs.StepCosts`` (under the
    fake mode of ``args``, where they are fake) and return this rank's
    ``flops``, ``bytes``, ``collectives`` (a ``CollectiveLog``),
    ``memory`` (``StepCosts.memory()``), ``kernel_calls`` (the kernels'
    fake calls by design) and the ``wall_s`` of the run; with
    ``tag_buffers`` also ``peak_buffers`` (``StepCosts.peak_buffers``)."""
    from torch._guards import detect_fake_mode
    from torch.distributed.tensor import DTensor

    from repro_torch.core import tree
    from repro_torch.kernels import ops
    from repro_torch.launch.costs import StepCosts

    fake = detect_fake_mode(tuple(
        t.to_local() if isinstance(t, DTensor) else t
        for t in tree.leaves(args) if isinstance(t, torch.Tensor)))
    before = ops.fake_design_counts()
    costs = StepCosts(tag_buffers)
    costs.track(args)
    gc.collect()
    gc.disable()  # storages held by reference cycles die when the step ends,
    try:          # not whenever the collector happens to run: a repeatable peak
        t0 = time.perf_counter()
        with fake if fake is not None else contextlib.nullcontext(), costs:
            out = step(*args)
        costs.output(out)
        wall = time.perf_counter() - t0
        del out
    finally:
        gc.enable()
    after = ops.fake_design_counts()
    calls = {k: {d: after[k][d] - before[k][d] for d in after[k]} for k in after}
    out = {"flops": costs.flops, "bytes": costs.bytes,
           "collectives": costs.collectives, "memory": costs.memory(),
           "kernel_calls": calls, "wall_s": wall}
    if tag_buffers:
        out["peak_buffers"] = costs.peak_buffers
    return out


#: the lengths an all-recurrent cell is run at (module docstring), by kind:
#: whole mLSTM chunks, two of them at least for a train step
TRIP_LENGTHS = {"prefill": (256, 512), "train": (512, 768)}


def trip_lengths(cfg, shape) -> tuple[int, int] | None:
    """The two lengths ``run_abstract`` runs ``shape`` at, where it counts
    trips (module docstring): an all-recurrent model's train or prefill
    cell longer than the second, on whole chunks of the first's step."""
    if any(b not in ("mlstm", "slstm") for b in cfg.block_pattern):
        return None
    lengths = TRIP_LENGTHS.get(shape.kind)
    if lengths is None or shape.seq <= lengths[1] or shape.seq % (lengths[1] - lengths[0]):
        return None
    return lengths


def _extend(a, b, t: float):
    """``a + (b - a) * t`` through every count of a ``measure_step`` result
    (ints stay ints: ``t`` is whole)."""
    from repro_torch.launch.hlo_analysis import CollectiveLog

    if isinstance(a, dict):
        return {k: _extend(a.get(k, 0), b.get(k, 0), t) for k in set(a) | set(b)}
    if isinstance(a, CollectiveLog):
        out = CollectiveLog()
        for name in ("counts", "result_bytes", "wire"):
            got = _extend(dict(getattr(a, name)), dict(getattr(b, name)), t)
            getattr(out, name).update({k: v for k, v in got.items() if v})
        return out
    return type(a)(a + (b - a) * t)


def run_abstract(cfg, shape, mesh, *, fsdp=None, policy_override=None,
                 trips: bool = True) -> tuple:
    """``build_cell`` abstractly on ``mesh`` and ``measure_step`` of its
    step -> (costs, plan, policy).  With ``trips`` a cell of
    ``trip_lengths`` is run at those two lengths and its counts extended
    to the cell's (``costs["trip_counted"]`` names the lengths)."""
    lengths = trip_lengths(cfg, shape) if trips else None
    if lengths is not None:  # under the cell's own plan, at both lengths
        import dataclasses

        from repro_torch.launch.mesh import mesh_axes_dict

        plan, policy = None, policy_override
        if policy is None:
            plan, policy = _plan_cell(cfg, shape, mesh_axes_dict(mesh),
                                      shape.kind == "train" if fsdp is None else fsdp)
        a, b = (run_abstract(cfg, dataclasses.replace(shape, seq=s), mesh,
                             policy_override=policy, trips=False)[0] for s in lengths)
        t = (shape.seq - lengths[0]) // (lengths[1] - lengths[0])
        costs = {k: _extend(a[k], b[k], t) for k in ("flops", "bytes", "collectives",
                                                      "memory", "kernel_calls")}
        costs.update(wall_s=a["wall_s"] + b["wall_s"], trip_counted=list(lengths))
        return costs, plan, policy
    step, args, _, plan, policy = build_cell(cfg, shape, mesh, fsdp=fsdp,
                                             policy_override=policy_override)
    costs = measure_step(step, args)
    del step, args
    gc.collect()
    return costs, plan, policy


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·tokens (train) / 2·N_active·tokens (fwd)."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n * shape.batch * shape.seq
    return 2.0 * n * shape.batch


def inner_scan_correction(cfg, shape) -> float:
    """Analytic FLOPs missing because inner *time* scans (sLSTM time loop,
    mLSTM chunk loop) are counted once by XLA cost analysis.  Returns a
    *global* FLOP count to add.  SSM chunk-loop bodies are O(s·b·d·n) —
    negligible vs the FFN — and are skipped (documented).  The port counts
    every time step (its loops run eagerly) and adds none of it."""
    if shape.kind == "decode":
        return 0.0  # decode takes one recurrent step: counted exactly
    s, b = shape.seq, shape.batch
    D = cfg.d_model
    mult = 3.0 if shape.kind == "train" else 1.0  # bwd ~ 2x fwd
    total = 0.0
    for blk in cfg.blocks():
        if blk == "slstm":
            per_unit = s * b * 16 * D * D          # x@W(4D) + h@R(4D) per step
            total += per_unit * (1 - 1 / max(s, 1)) * mult
        elif blk == "mlstm":
            L = min(256, s)
            H = cfg.n_heads
            dh = D // H
            trips = s // L
            per_chunk = b * H * (3 * 2 * L * L * dh + 2 * 2 * L * dh * dh)
            per_unit = trips * per_chunk
            total += per_unit * (1 - 1 / max(trips, 1)) * mult
    return total


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             fsdp: bool | None = None, policy_override=None,
             out_dir: str = "artifacts/dryrun_torch", tag: str = "",
             skip_full: bool = False, cfg_override=None) -> dict:
    from repro_torch.configs import SHAPES, get_config

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    mesh = production_mesh(multi_pod)
    chips = mesh.world_size
    mesh_name = "x".join(str(s) for s in mesh.sizes.values())

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "kind": shape.kind, "tag": tag, "ok": False,
           "device": {"name": DEVICE, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "hbm_bytes": HBM_BYTES}}
    if not cfg.supports(shape):
        rec["skipped"] = ("long_500k needs sub-quadratic attention; "
                          f"{arch} is pure full-attention (DESIGN.md §4)")
        return rec

    # ---- the production step, run abstractly: proof + memory + costs --------
    t0 = time.time()
    costs = None
    if not skip_full:
        costs, plan, policy = run_abstract(cfg, shape, mesh, fsdp=fsdp,
                                           policy_override=policy_override)
        m = costs["memory"]
        rec["memory"] = {
            "argument_gb": m["argument"] / 1e9,
            "output_gb": m["output"] / 1e9,
            "temp_gb": m["temp"] / 1e9,
            "alias_gb": 0.0,
            "per_device_gb": m["peak"] / 1e9,
        }
        rec["memory_bytes"] = m
        rec["fits_80gb"] = m["peak"] <= HBM_BYTES
        rec["kernel_calls"] = costs["kernel_calls"]
        if "trip_counted" in costs:
            rec["trip_counted"] = {
                "lengths": costs["trip_counted"],
                "rule": "counts affine in the length: run at these two lengths and "
                        "extended to the cell's (launch/dryrun.py)"}
    else:
        plan, policy = _plan_only(cfg, shape, mesh, fsdp, policy_override)
    rec["compile_s"] = round(time.time() - t0, 1)
    if plan is not None:
        rec["plan_cost_floats"] = plan.cost
        rec["analysis"] = _static_analysis(cfg, shape, mesh, plan)
    rec["policy"] = {k: list(v) for k, v in policy.label_axes.items()}
    rec["fsdp"] = list(policy.fsdp_axes)
    if costs is None:
        rec["total_s"] = round(time.time() - t0, 1)
        rec["ok"] = True
        return _write(rec, out_dir, tag)

    # ---- roofline: one run counts every layer ----------------------------------
    wire, by_kind, coll_plain = costs["collectives"].result()
    flops_dev = float(costs["flops"])
    bytes_dev = float(costs["bytes"])
    mf = model_flops(cfg, shape)
    # buffer-touch floor: every live buffer read+written once per step.
    # the summed op bytes are a no-fusion-reuse UPPER bound; truth is in
    # [t_memory_lb, t_memory].
    touch = 2.0 * rec["memory"]["per_device_gb"] * 1e9
    rec["roofline"] = {
        "hlo_flops_per_dev": flops_dev,
        "hlo_bytes_per_dev": bytes_dev,
        "touch_bytes_per_dev": touch,
        "t_memory_lb_s": touch / HBM_BW,
        "collective_wire_bytes_per_dev": wire,
        "collective_operand_bytes_per_dev": coll_plain,
        "collective_by_kind": by_kind,
        "collective_counts": dict(costs["collectives"].counts),
        "inner_scan_flops_corr_per_dev": 0.0,
        "t_compute_s": flops_dev / PEAK_FLOPS,
        "t_memory_s": bytes_dev / HBM_BW,
        "t_collective_s": wire / NVLINK_BW,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(flops_dev * chips, 1.0),
    }
    terms = {"compute": rec["roofline"]["t_compute_s"],
             "memory": rec["roofline"]["t_memory_s"],
             "collective": rec["roofline"]["t_collective_s"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["roofline_fraction"] = terms["compute"] / max(max(terms.values()), 1e-30)
    terms_lb = dict(terms, memory=rec["roofline"]["t_memory_lb_s"])
    rec["bottleneck_lb"] = max(terms_lb, key=terms_lb.get)
    rec["roofline_fraction_lb"] = (terms_lb["compute"]
                                   / max(max(terms_lb.values()), 1e-30))
    rec["total_s"] = round(time.time() - t0, 1)
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    rec["ok"] = True
    return _write(rec, out_dir, tag)


def _write(rec: dict, out_dir: str, tag: str) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _static_analysis(cfg, shape, mesh, plan) -> dict:
    """Record the repro_torch.analysis verdict for the planned cell next to
    the abstract run's numbers: the static verifier re-checks the exact
    plan the dry run ran (graph/plan/schedule/memory passes,
    backend-free).  Informational — findings land in the record, they
    don't fail the sweep."""
    from repro_torch.analysis import analyze_program
    from repro_torch.launch.mesh import mesh_axes_dict
    from repro_torch.models.eingraphs import program_for

    try:
        report = analyze_program(program_for(cfg, shape),
                                 mesh_axes_dict(mesh), plan=plan)
    except Exception as e:  # never let verification sink the dry-run
        return {"error": f"{type(e).__name__}: {e}"}
    return {"n_errors": len(report.errors),
            "n_warnings": len(report.warnings),
            "codes": sorted(report.codes()),
            "peak_bytes_per_dev": report.memory.get("peak_bytes")}


def _plan_only(cfg, shape, mesh, fsdp, policy_override):
    from repro_torch.launch.mesh import mesh_axes_dict

    if policy_override is not None:
        return None, policy_override
    if fsdp is None:
        fsdp = shape.kind == "train"
    return _plan_cell(cfg, shape, mesh_axes_dict(mesh), fsdp)


def _calls(rec: dict) -> str:
    return ", ".join(f"{k} {sum(v.values())}"
                     for k, v in rec.get("kernel_calls", {}).items() if sum(v.values()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    # DTensor warns on every two-step all-gather over a pair of mesh axes
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    from repro_torch.configs import ARCH_IDS, SHAPES

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS + ["llama-7b"]:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells.append((args.arch, args.shape))

    failures = 0
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           out_dir=args.out, tag=args.tag)
            if rec.get("skipped"):
                print(f"SKIP {arch:18s} {shape:12s} {rec['skipped'][:58]}",
                      flush=True)
                continue
            r = rec["roofline"]
            print(f"OK   {arch:18s} {shape:12s} mesh={rec['mesh']:8s} "
                  f"mem={rec['memory']['per_device_gb']:7.2f}GB "
                  f"fits80={'y' if rec['fits_80gb'] else 'n'} "
                  f"t_c={r['t_compute_s']:.2e} t_m={r['t_memory_s']:.2e} "
                  f"t_x={r['t_collective_s']:.2e} {rec['bottleneck']:10s} "
                  f"frac={rec['roofline_fraction']:.2f} "
                  f"calls=[{_calls(rec)}] [{rec['total_s']}s]", flush=True)
        except Exception:
            failures += 1
            print(f"FAIL {arch:18s} {shape:12s}", flush=True)
            traceback.print_exc()
        finally:
            gc.collect()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
