"""The dry run (``repro_torch.launch.dryrun``) on the CPU, held against the
reference's dry run and against real runs of the same steps.

1. **Pure functions equal the reference's.**  ``_plan_cell``'s plan and
   policy for every dense architecture x train_4k / prefill_32k /
   decode_32k on ``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model:
   16}`` (and the plans do not depend on ``PYTHONHASHSEED``),
   ``model_flops`` and ``inner_scan_correction`` over every config and
   shape, ``_wire_bytes`` for every kind and group size, and
   ``_static_analysis``'s verdict.
2. **The recorder** prices the collectives DTensor issues on a fake
   256-rank group as the reference's HLO parser prices the same
   collectives, and shows ``gspmd.local_einsum`` moving the operand that
   costs fewer bytes.
3. **``build_cell``** makes abstract (meta) arguments, donates what the
   reference donates, and gives the AdamW moments the parameters'
   placements.
4. **Abstract equals real.**  Reduced llama and reduced paligemma (with
   its prefix) on a fake 4-rank group, their blocks fake CPU tensors,
   against the same steps on 4 real gloo CPU ranks: FLOPs, bytes and the
   collectives by kind equal, and the peak of live bytes from the same
   tracker within 1% (equal here: the fake tensors' kernels allocate what
   the CPU's do).  The cells include a sequence-parallel policy ({b: data,
   s: model}), whose decode step runs on a time-split cache; the recorder
   prices a point-to-point send as a collective-permute.  The two model
   paths the production cells needed (products on local blocks, the
   decode step on a time-split cache) equal one rank numerically.
5. **Full size.**  llama-7b decode_32k on (16, 16) runs through
   ``run_cell`` without initialising CUDA, and its argument bytes are the
   local blocks of its placed parameters, caches and tokens.
6. **The kernels' operators** pass abstract tensors through: shapes,
   FLOP formulas (the plain versions' counts), calls by design counted
   apart from launches, and CPU tensors still refused.
"""
import math
import subprocess
import sys
import types

import jax

jax.devices()  # backends up: importing repro.launch.dryrun then leaves XLA_FLAGS alone

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro.launch.dryrun as ref_dry  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import hlo_analysis as ref_hlo  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402

DENSE = ["paligemma-3b", "musicgen-large", "minicpm-2b", "qwen1.5-110b",
         "nemotron-4-15b", "yi-9b", "llama-7b"]
CELLS = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True, scope="module")
def _no_group_left():
    """The fake process group the abstract meshes run over lives in this
    process: take it down after the module, so that no other test in the
    worker sees it."""
    yield
    dryrun._MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 1. pure functions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", DENSE)
def test_plan_cell_equals_reference(arch, mesh):
    axes = MESHES[mesh]
    for name in CELLS:
        fsdp = SHAPES[name].kind == "train"
        plan, policy = dryrun._plan_cell(get_config(arch), SHAPES[name], axes, fsdp)
        ref_plan, ref_policy = ref_dry._plan_cell(ref_get_config(arch),
                                                  REF_SHAPES[name], axes, fsdp)
        assert plan.to_json() == ref_plan.to_json(), (arch, name)
        assert ({k: tuple(v) for k, v in policy.label_axes.items()}
                == {k: tuple(v) for k, v in ref_policy.label_axes.items()}), (arch, name)
        assert tuple(policy.fsdp_axes) == tuple(ref_policy.fsdp_axes)


def test_plan_deterministic_across_processes():
    """The port's twin of the reference's test: tie-optimal plans must not
    depend on PYTHONHASHSEED."""
    snippet = (
        "from repro_torch.configs import get_config, SHAPES\n"
        "from repro_torch.models.eingraphs import plan_for\n"
        "cfg = get_config('musicgen-large')\n"
        "g, plan, pol = plan_for(cfg, SHAPES['decode_32k'],"
        " {'data':16,'model':16})\n"
        "print(sorted(pol.label_axes.items()))\n")
    outs = set()
    for seed in ("0", "1", "2"):
        proc = subprocess.run(
            [sys.executable, "-c", snippet], capture_output=True, text=True,
            env={"PYTHONPATH": "src", "PYTHONHASHSEED": seed, "PATH": "/usr/bin:/bin"},
            timeout=240)
        assert proc.returncode == 0, proc.stderr[-800:]
        outs.add(proc.stdout.strip())
    assert len(outs) == 1, outs


@pytest.mark.parametrize("arch", ARCH_IDS + ["llama-7b"])
def test_model_flops_and_inner_scan_correction_equal_reference(arch):
    for name in SHAPES:
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        assert dryrun.model_flops(cfg, SHAPES[name]) == ref_dry.model_flops(
            ref_cfg, REF_SHAPES[name])
        assert dryrun.inner_scan_correction(cfg, SHAPES[name]) == \
            ref_dry.inner_scan_correction(ref_cfg, REF_SHAPES[name])


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all", "collective-permute"])
def test_wire_bytes_equal_reference(kind):
    for k in (1, 2, 4, 16, 256, 512):
        for r in (0, 4, 32768, 123457):
            assert hlo_analysis._wire_bytes(kind, r, k) == ref_hlo._wire_bytes(kind, r, k)


def test_static_analysis_equals_reference():
    """The reference's own case (reduced llama, prefill 32 x 4, a 1x1 mesh)
    and one production cell (llama-7b decode_32k on 16 x 16)."""
    from jax.sharding import Mesh as JaxMesh

    from repro.core.decomp import eindecomp as ref_eindecomp
    from repro.models.eingraphs import program_for as ref_program_for
    from repro_torch.core.decomp import eindecomp
    from repro_torch.models.eingraphs import program_for

    cfg, ref_cfg = reduced(get_config("llama-7b")), ref_reduced(ref_get_config("llama-7b"))
    shape, ref_shape = ShapeConfig("t", "prefill", 32, 4), RefShapeConfig("t", "prefill", 32, 4)
    axes = {"data": 1, "model": 1}
    ref_mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    mesh = types.SimpleNamespace(sizes=axes)
    rec = dryrun._static_analysis(
        cfg, shape, mesh, eindecomp(program_for(cfg, shape).graph, 1, mesh_axes=axes))
    ref_rec = ref_dry._static_analysis(
        ref_cfg, ref_shape, ref_mesh,
        ref_eindecomp(ref_program_for(ref_cfg, ref_shape).graph, 1, mesh_axes=axes))
    assert rec == ref_rec and rec["peak_bytes_per_dev"] > 0

    axes = MESHES["16x16"]
    big = types.SimpleNamespace(axis_names=tuple(axes),
                                devices=np.empty(tuple(axes.values())))
    plan, _ = dryrun._plan_cell(get_config("llama-7b"), SHAPES["decode_32k"], axes, False)
    ref_plan, _ = ref_dry._plan_cell(ref_get_config("llama-7b"), REF_SHAPES["decode_32k"],
                                     axes, False)
    rec = dryrun._static_analysis(get_config("llama-7b"), SHAPES["decode_32k"],
                                  types.SimpleNamespace(sizes=axes), plan)
    ref_rec = ref_dry._static_analysis(ref_get_config("llama-7b"),
                                       REF_SHAPES["decode_32k"], big, ref_plan)
    assert rec == ref_rec, (rec, ref_rec)


# ---------------------------------------------------------------------------
# 2. the collective recorder
# ---------------------------------------------------------------------------


def test_recorder_prices_dtensor_collectives_as_reference_parser():
    """DTensor on a fake 256-rank group: an all-reduce of f32[128, 64] over
    groups of 16 and an all-gather to f32[256, 64] over groups of 4, priced
    as the reference's parser prices the same HLO."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    rec = hlo_analysis.CollectiveRecorder()
    m16 = dryrun.abstract_mesh((16, 16), ("data", "model"))
    x = DTensor.from_local(torch.empty(128, 64, device="meta"), m16.dmesh,
                           [Replicate(), Partial()], run_check=False)
    with rec:
        x.redistribute(m16.dmesh, [Replicate(), Replicate()])
    m4 = dryrun.abstract_mesh((64, 4), ("data", "model"))
    y = DTensor.from_local(torch.empty(64, 64, device="meta"), m4.dmesh,
                           [Replicate(), Shard(0)], run_check=False)
    with rec:
        y.redistribute(m4.dmesh, [Replicate(), Replicate()])
    hlo = """
HloModule test

ENTRY %main (p: f32[128,64]) -> f32[256,64] {
  %p = f32[128,64]{1,0} parameter(0)
  %ar = f32[128,64]{1,0} all-reduce(%p), replica_groups=[16,16]<=[256], to_apply=%add
  ROOT %ag = f32[256,64]{1,0} all-gather(%ar), replica_groups=[64,4]<=[256], dimensions={0}
}
"""
    assert rec.result() == ref_hlo.parse_collectives(hlo, 256)
    assert rec.log.counts == {"all-reduce": 1, "all-gather": 1}


@pytest.mark.parametrize("batch", [2, 64])
def test_local_einsum_moves_the_operand_that_costs_fewer_bytes(batch):
    """A data-parallel product on 2 fake ranks: x (b, s, a) split along b,
    its weight (a, f) stored split along a.  A small batch moves x (re-split
    along a, the partial sums reduce-scattered back along b: no weight
    gathered); a large one gathers the weight.  Either way the output keeps
    x's layout."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core import gspmd

    mesh = dryrun.abstract_mesh((2,), ("data",))
    a, f = 64, 4096
    x = DTensor.from_local(torch.empty(batch // 2, 8, a, device="meta"), mesh.dmesh,
                           [Shard(0)], run_check=False)
    w = DTensor.from_local(torch.empty(a // 2, f, device="meta"), mesh.dmesh,
                           [Shard(0)], run_check=False)
    rec = hlo_analysis.CollectiveRecorder()
    with rec:
        y = gspmd.local_einsum("bsa,af->bsf", x, w)
    assert y.shape == (batch, 8, f) and tuple(y.placements) == (Shard(0),)
    got = rec.log.summary()
    if batch == 2:
        assert "reduce-scatter" in got and "all-gather" not in got, got
    else:
        assert list(got) == ["all-gather"], got
        assert (got["all-gather"]["count"], got["all-gather"]["bytes"]) == (1, a * f * 4)


# ---------------------------------------------------------------------------
# 3. build_cell
# ---------------------------------------------------------------------------


def test_build_cell_abstract_arguments():
    """The reference's ``test_build_cell_shapes_decode`` and
    ``test_train_cell_optimizer_shardings_attached`` for xlstm-125m on
    1x1: every argument abstract, ``donate`` as the reference's, moments
    beside every parameter.  On a 4-rank mesh the moments carry the
    parameters' placements."""
    from torch.distributed.tensor import DTensor

    cfg = get_config("xlstm-125m")
    one = dryrun.abstract_mesh((1, 1))
    step, args, donate, plan, policy = dryrun.build_cell(cfg, SHAPES["decode_32k"], one)
    leaves = [t for t in tree.leaves(args) if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert donate == (2,)
    step, (params, opt, batch), donate, plan, policy = dryrun.build_cell(
        cfg, SHAPES["train_4k"], one)
    assert donate == (0, 1)
    for p, m, v in zip(tree.leaves(params), tree.leaves(opt.m), tree.leaves(opt.v)):
        assert m.shape == v.shape == p.shape and m.dtype == torch.float32
        assert m.device.type == "meta"

    mesh = dryrun.abstract_mesh((2, 2))
    _, (params, opt, _), _, _, _ = dryrun.build_cell(
        reduced(get_config("llama-7b")), ShapeConfig("t", "train", 32, 4), mesh)
    placed = 0
    for p, m in zip(tree.leaves(params), tree.leaves(opt.m)):
        assert isinstance(m, DTensor) and m.placements == p.placements
        placed += any(pl.is_shard() for pl in p.placements)
    assert placed  # some parameter is split


# ---------------------------------------------------------------------------
# 4. abstract against real: a fake 4-rank group against 4 gloo CPU ranks
# ---------------------------------------------------------------------------

REAL_CELLS = [  # (arch, shape, a manual policy or None for the cell's plan)
    ("llama-7b", ("train", 32, 4), None),
    ("llama-7b", ("decode", 32, 4), None),
    ("llama-7b", ("prefill", 32, 4), {"b": "data", "s": "model"}),
    ("llama-7b", ("decode", 32, 4), {"b": "data", "s": "model"}),
    ("paligemma-3b", ("prefill", 32, 4), None),
    ("paligemma-3b", ("train", 32, 4), None),
    ("qwen2-moe-a2.7b", ("train", 32, 4), {"e": "model", "b": "data"}),
    ("xlstm-125m", ("prefill", 32, 4), None),
]


def _cell(arch, shape, manual):
    from repro_torch.models.policy import manual_policy

    cfg = reduced(get_config(arch))
    shape = ShapeConfig("t", *shape)
    return cfg, shape, None if manual is None else manual_policy(manual)


def _summary(costs: dict) -> dict:
    return {"flops": costs["flops"], "bytes": costs["bytes"],
            "collectives": costs["collectives"].summary(),
            "memory": costs["memory"], "kernel_calls": costs["kernel_calls"]}


def real_rank(rank: int, world: int) -> list:
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh({"data": 2, "model": 2}, device="cpu")
    out = []
    for arch, shape, manual in REAL_CELLS:
        cfg, shape, policy = _cell(arch, shape, manual)
        step, args, _, _, _ = dryrun.build_cell(cfg, shape, mesh, policy_override=policy,
                                                abstract=False)
        out.append(_summary(dryrun.measure_step(step, args)))
        del step, args
    # a point-to-point exchange (ranks 0 <-> 1, 2 <-> 3): each send is a
    # collective-permute of the bytes sent
    rec = hlo_analysis.CollectiveRecorder()
    buf = torch.full((256,), float(rank))
    with rec:
        if rank % 2 == 0:
            dist.send(buf, rank + 1)
            dist.recv(buf, rank + 1)
        else:
            dist.recv(buf, rank - 1)
            dist.send(buf, rank - 1)
    out.append(rec.log.summary())
    return out


def abstract_cells() -> list:
    """The cells on a fake 4-rank group, fake CPU blocks (the plain path,
    as on the real CPU ranks)."""
    mesh = dryrun.abstract_mesh((2, 2), device="cpu")
    out = []
    for arch, shape, manual in REAL_CELLS:
        cfg, shape, policy = _cell(arch, shape, manual)
        out.append(_summary(dryrun.run_abstract(cfg, shape, mesh, policy_override=policy)[0]))
    return out


def test_abstract_run_equals_real_gloo_run(tmp_path):
    """Both sides run their cells in the same order in fresh processes: a
    process's history (DTensor's caches hold some of the tensors they
    see) can keep a buffer alive longer, which at these sizes is more than
    1% of a peak."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch.mesh import spawn

    real = spawn(4, real_rank, tmpdir=tmp_path, timeout=600)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        abstract = pool.submit(abstract_cells).result(timeout=600)
    for i, (arch, shape, manual) in enumerate(REAL_CELLS):
        got, want = abstract[i], real[0][i]
        what = (arch, shape, manual)
        assert got["flops"] == want["flops"] > 0, what
        assert got["bytes"] == want["bytes"], what
        assert got["collectives"] == want["collectives"], what
        assert got["collectives"], what  # the cell moves something
        peak, real_peak = got["memory"]["peak"], want["memory"]["peak"]
        assert abs(peak - real_peak) <= 0.01 * real_peak, (what, got["memory"], want["memory"])
        assert got["memory"]["argument"] == want["memory"]["argument"], what
        for r in real[1:]:  # every rank of the real group did the same work
            assert r[i]["flops"] == want["flops"]
    for r in real:
        assert r[-1] == {"collective-permute": {"count": 1, "bytes": 1024,
                                                "wire_bytes": 1024.0}}


SEQ_TOL = 1e-5  # x max|one rank|: float32 sums over the blocks in another order


def _seq_parallel(mesh, fsdp: tuple = ()):
    """Reduced llama, float32, under {b: data, s: model} (the weights
    stored on ``fsdp``): prefill logits, 18 decode steps from zero caches
    (the time-split cache's second block first written at step 16), and
    the loss's gradients."""
    from repro_torch.core.gspmd import full
    from repro_torch.data.synthetic import place_batch
    from repro_torch.models import transformer as tf
    from repro_torch.models.policy import manual_policy

    cfg = reduced(get_config("llama-7b"))
    policy = manual_policy({"b": "data", "s": "model"}, fsdp_axes=fsdp)
    toks = np.random.default_rng(24).integers(0, cfg.vocab, size=(4, 32)).astype(np.int32)
    params = tf.place_params(tf.init_params(cfg, seed=7, device="cpu"), cfg, policy, mesh)
    batch = place_batch({"tokens": toks, "labels": toks}, policy, mesh)
    logits, _, _ = tf.forward(params, batch["tokens"], cfg, policy=policy, mesh=mesh)
    caches = tf.place_caches(tf.init_caches(cfg, 4, 32, device="cpu"), cfg, 4, 32,
                             policy, mesh)
    steps = []
    for pos in range(18):
        step_toks = place_batch({"tokens": toks[:, pos:pos + 1]}, policy, mesh)["tokens"]
        out, caches = tf.decode_step(params, step_toks, caches, pos, cfg,
                                     policy=policy, mesh=mesh)
        steps.append(full(out).detach().numpy())
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = tf.loss_fn(params, batch, cfg, policy=policy, mesh=mesh)
    grads = [full(g).numpy() for g in torch.autograd.grad(loss, leaves)]
    split = getattr(caches[0].k, "placements", ())
    return {"logits": full(logits).detach().numpy(), "decode": steps,
            "loss": float(full(loss).detach()), "grads": grads,
            "time_split": any(p.is_shard() and p.dim == 2 for p in split)}


def seq_parallel_rank(rank: int, world: int) -> list:
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh({"data": 2, "model": 2}, device="cpu")
    return [_seq_parallel(mesh, fsdp) for fsdp in ((), ("data",))]


def test_sequence_parallel_rows_and_time_split_decode_equal_one_rank(tmp_path):
    """The two paths the production cells needed: a product whose
    activation splits batch and sequence runs on the local blocks
    (``gspmd.matmul``), and the decode step on a cache split along time
    combines the blocks' softmax partials.  On 4 gloo ranks under {b: data,
    s: model}, with the weights whole and stored on "data" (gathered for
    the product; their gradients reduce-scattered back), the logits, every
    decode step and every gradient equal one rank's within SEQ_TOL of their
    scale."""
    from repro_torch.launch.mesh import Mesh, spawn

    got = [r for ranks in spawn(4, seq_parallel_rank, tmpdir=tmp_path, timeout=300)
           for r in ranks]
    want = _seq_parallel(Mesh({"data": 1, "model": 1}, device="cpu"))

    def close(a, b, what):
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= SEQ_TOL * scale, what

    for r in got:
        assert r["time_split"]  # the caches' time dim (of "L b t k d") is split
        close(r["logits"], want["logits"], "prefill logits")
        for i, (a, b) in enumerate(zip(r["decode"], want["decode"])):
            close(a, b, f"decode step {i}")
        assert abs(r["loss"] - want["loss"]) <= SEQ_TOL * abs(want["loss"])
        for i, (a, b) in enumerate(zip(r["grads"], want["grads"])):
            close(a, b, f"gradient leaf {i}")


# ---------------------------------------------------------------------------
# 5. full size
# ---------------------------------------------------------------------------


def _block_bytes(shape, dtype, placements, mesh) -> int:
    return math.prod(dryrun._block_shape(shape, placements, mesh)) * dtype.itemsize


def test_full_size_decode_on_the_production_mesh(tmp_path):
    """llama-7b decode_32k on (16, 16): it runs as rank 0 of a fake
    256-rank group with CUDA never initialised, writes its record, and its
    argument bytes are the local blocks of the parameters and caches as
    ``param_shardings`` and ``cache_shardings`` place them, and of the
    token ids (``pos`` is a Python int)."""
    from repro_torch.data.synthetic import batch_shardings
    from repro_torch.models import transformer as tf

    rec = dryrun.run_cell("llama-7b", "decode_32k", out_dir=str(tmp_path))
    assert rec["ok"] and not torch.cuda.is_initialized()
    assert (tmp_path / "llama-7b__decode_32k__16x16.json").exists()
    cfg, shape = get_config("llama-7b"), SHAPES["decode_32k"]
    mesh = dryrun.production_mesh()
    _, policy = dryrun._plan_cell(cfg, shape, dict(mesh.sizes), False)
    want = 0
    for t, pl in zip(tree.leaves(tf.init_params(cfg, device="meta")),
                     _placement_leaves(tf.param_shardings(cfg, policy, mesh))):
        want += _block_bytes(t.shape, t.dtype, pl, mesh)
    kv = cfg.kv_len(shape)
    for t, pl in zip(tree.leaves(tf.init_caches(cfg, shape.batch, kv, device="meta")),
                     _placement_leaves(tf.cache_shardings(cfg, shape.batch, kv, policy, mesh))):
        want += _block_bytes(t.shape, t.dtype, pl, mesh)
    tokens = tf.input_specs(cfg, shape)["tokens"]
    want += _block_bytes(tokens.shape, tokens.dtype,
                         batch_shardings(policy, mesh, {"tokens": tokens.shape})["tokens"],
                         mesh)
    assert rec["memory_bytes"]["argument"] == want
    r = rec["roofline"]
    assert r["hlo_flops_per_dev"] > 0 and r["collective_wire_bytes_per_dev"] > 0
    assert rec["fits_80gb"] and rec["memory"]["alias_gb"] == 0.0


def _placement_leaves(shardings) -> list:
    """The leaves of a tree whose leaves are tuples of placements."""
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings) for x in _placement_leaves(shardings[k])]
    if isinstance(shardings, (list, tuple)) and shardings and not hasattr(
            shardings[0], "is_shard"):
        return [x for s in shardings for x in _placement_leaves(s)]
    return [shardings]


def test_waiting_blocks_and_skipped_shapes(monkeypatch, capsys):
    """The MoE cells, which waited for their blocks' mesh path, run: main()
    prints mixtral's decode_32k as OK, long_500k of a full-attention model
    as SKIP, and exits 0."""
    for arch, shape, word in (("mixtral-8x7b", "decode_32k", "OK"),
                              ("llama-7b", "long_500k", "SKIP")):
        monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", arch, "--shape", shape,
                                          "--out", ""])
        dryrun.main()
        assert capsys.readouterr().out.startswith(word)


def _counts(costs: dict) -> tuple:
    return (costs["flops"], costs["bytes"], costs["memory"], costs["collectives"].summary(),
            costs["kernel_calls"])


@pytest.mark.parametrize("block,lengths", [("mlstm", None), ("slstm", (128, 256))])
def test_trip_counting_equals_the_full_loop(block, lengths, monkeypatch):
    """An all-recurrent cell's counts, run at two lengths and extended along
    the line through them (``run_abstract``'s trip counting), equal a full
    run at a longer length: FLOPs, bytes, live memory, collectives and
    kernel calls, for a train step and a prefill, on a fake 4-rank group.
    Each block kind alone (reduced xlstm's, one layer): a step is the sum
    of its blocks' costs and the embedding's and head's, each affine in the
    length.  The mLSTM at the cells' own lengths (whole 256-position
    chunks; two at least for a train step); the sLSTM's per-position loop
    at shorter ones, where its full run is affordable."""
    import dataclasses

    if lengths is not None:
        monkeypatch.setattr(dryrun, "TRIP_LENGTHS", {"prefill": lengths, "train": lengths})
    cfg = dataclasses.replace(reduced(get_config("xlstm-125m")), block_pattern=(block,),
                              n_layers=1)
    mesh = dryrun.abstract_mesh((2, 2))
    for kind, short in dryrun.TRIP_LENGTHS.items():
        shape = ShapeConfig("t", kind, short[1] + (short[1] - short[0]), 4)
        assert dryrun.trip_lengths(cfg, shape) == short
        ext = dryrun.run_abstract(cfg, shape, mesh)[0]
        assert ext["trip_counted"] == list(short)
        assert _counts(ext) == _counts(dryrun.run_abstract(cfg, shape, mesh, trips=False)[0])
    assert dryrun.trip_lengths(reduced(get_config("hymba-1.5b")), shape) is None


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m"])
def test_moe_hymba_and_xlstm_cells_run_on_the_production_mesh(arch):
    """decode_32k of a MoE, a hymba and an xLSTM config on (16, 16) runs
    through ``run_cell`` without initialising CUDA: a record of a batch
    split over the mesh (the recurrent blocks run on local rows), the MoE
    cell's expert products one ``gmm`` call a product a layer."""
    cfg = get_config(arch)
    rec = dryrun.run_cell(arch, "decode_32k", out_dir="")
    assert rec["ok"] and not rec["cuda_initialized"], rec
    assert rec["memory_bytes"]["argument"] > 0 and rec["roofline"]["hlo_flops_per_dev"] > 0
    calls = {k: sum(v.values()) for k, v in rec["kernel_calls"].items()}
    assert calls.get("gmm", 0) == (3 * cfg.n_layers if cfg.moe else 0), calls
    assert rec["policy"].get("b"), rec["policy"]  # the rows (and states) split


# ---------------------------------------------------------------------------
# 6. the kernels' operators on abstract tensors
# ---------------------------------------------------------------------------


def test_custom_ops_pass_abstract_tensors_through():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    b, hq, hkv, s, d = 2, 8, 2, 64, 128
    ops.reset_launch_counts()
    q = torch.empty(b, s, hq, d, dtype=torch.bfloat16, device="meta").transpose(1, 2)
    k = torch.empty(b, s, hkv, d, dtype=torch.bfloat16, device="meta").transpose(1, 2)
    with FlopCounterMode(display=False) as fc:
        o = ops.flash_attention(q, k, k, causal=True)
    assert o.shape == (b, hq, s, d) and o.dtype == torch.bfloat16 and o.device.type == "meta"
    assert fc.get_total_flops() == 4 * b * hq * s * s * d
    # the formula is the plain version's count
    g = torch.Generator().manual_seed(0)
    qc, kc = (torch.randn(b, h, s, d, generator=g) for h in (hq, hkv))
    with FlopCounterMode(display=False) as fc_plain:
        ref.attention(qc, kc, kc, causal=True)
    assert fc_plain.get_total_flops() == fc.get_total_flops()
    x = torch.empty(64, 96, device="meta")
    w = torch.empty(96, 48, device="meta")
    with FlopCounterMode(display=False) as fc:
        y = ops.matmul(x, w)
        z = ops.gmm(torch.empty(4, 16, 96, device="meta"), torch.empty(4, 96, 48, device="meta"))
    assert y.shape == (64, 48) and z.shape == (4, 16, 48)
    assert fc.get_total_flops() == 2 * 64 * 96 * 48 + 2 * 4 * 16 * 96 * 48
    with FakeTensorMode():  # a fake CUDA tensor, as well as a meta one
        fo = ops.flash_attention(torch.empty(1, 4, 32, 64, device="cuda"),
                                 torch.empty(1, 4, 32, 64, device="cuda"),
                                 torch.empty(1, 4, 32, 64, device="cuda"))
    assert fo.device.type == "cuda" and not torch.cuda.is_initialized()
    assert ops.fake_design_counts() == {
        "flash_attention": {"wgmma": 1, "ffma": 1, "template": 0},
        "matmul": {"wgmma": 0, "ffma": 1, "template": 0},
        "gmm": {"wgmma": 0, "ffma": 1, "template": 0}}
    assert all(n == 0 for n in ops.launch_counts().values())
    # the rule reads a view's offset: 4 bytes past a 16-byte line, the template
    off = torch.empty(1 + 4 * 32 * 64, device="meta")[1:].view(1, 4, 32, 64)
    assert fa.design(off, off, off) == "template"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(qc, kc, kc)  # a CPU tensor still reaches no fallback
    ops.reset_launch_counts()
    assert ops.fake_design_counts()["flash_attention"]["wgmma"] == 0


def test_step_costs_on_a_small_real_step():
    """StepCosts on plain CPU tensors: the FLOPs FlopCounterMode counts,
    the bytes every op reads and writes, and the peak of live storages."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.costs import StepCosts

    x = torch.ones(64, 32)
    w = torch.ones(32, 16)

    def step(x, w):
        y = x @ w                  # 64 x 16 new
        z = torch.relu(y) + 1.0    # two more 64 x 16, relu's freed at once
        return z.sum(0)            # 16

    costs = StepCosts()
    costs.track((x, w))
    with costs:
        out = step(x, w)
    costs.output(out)
    with FlopCounterMode(display=False) as fc:
        step(x, w)
    assert costs.flops == fc.get_total_flops() == 2 * 64 * 32 * 16
    f = 4
    args = (64 * 32 + 32 * 16) * f
    assert costs.memory()["argument"] == args
    assert costs.memory()["output"] == 16 * f
    # peak: the arguments, y, relu(y) and z alive at once
    assert costs.memory()["peak"] == args + 3 * 64 * 16 * f
    mm = (64 * 32 + 32 * 16 + 64 * 16) * f
    assert costs.bytes == mm + 2 * 64 * 16 * f + 2 * 64 * 16 * f + (64 * 16 + 16) * f
