"""Checkpoints of a run on a mesh, on gloo CPU ranks: ``train(mesh=,
ckpt_dir=)`` saves from 2 ranks and restarts on another mesh, and the
checkpoints cross packages in both directions.

Reduced llama-7b (float32), b=4, s=16, 3 steps with a checkpoint at step 2
(``ckpt_every=2``; lr is 0 at step 0, so step 2 starts from weights and
moments that step 1 moved).  One spawn of 2 ranks (``launch.mesh.spawn``,
``file://`` rendezvous under a pytest tmp path) runs, in order:

* the uninterrupted run on ``{data: 2}``, which writes steps 2 and 3;
* the run restarted from step 2 (a copy of that directory alone) on
  ``{data: 2}`` and on ``{model: 2}``; the pytest process restarts it on
  one rank.  The restart on the same mesh gives the uninterrupted run's
  step-2 loss and grad norm bit for bit; the others within 1e-5 relative
  (the sharded sums add in other orders);
* step 2 restored directly: on ``{data: 2}`` through the placements of a
  placed ``like`` tree, on ``{model: 2}`` through ``shardings=`` specs on
  the mesh; every leaf's ``full_tensor()`` equals its file bit for bit;
* ``restore_latest`` with rank 1 shown a stale listing: both ranks
  restore the step rank 0 chose;
* a checkpoint the reference saved, restored onto ``{model: 2}``: every
  leaf equal to the reference's array;
* ``save_checkpoint`` of bfloat16 DTensor leaves (one split unevenly) and
  an int32 leaf, restored equal.

Every rank records the directories it wrote: rank 0 all of them, rank 1
none.  The 2-rank checkpoint loads in the reference's ``load_checkpoint``
with the reference's tree: leaf shapes and dtypes equal, the manifest's
keys the reference's own, and the parameters, carried into the port by
``from_reference_params``, equal to the files.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.checkpoint import load_checkpoint as ref_load  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("t", "train", 16, 4)
STEPS, EVERY = 3, 2
STEP2 = "step_00000002"
RESTARTS = ("data2", "model2", "one")
TOL = 1e-5


def _cfg():
    return dataclasses.replace(reduced(get_config("llama-7b")), dtype="float32")


def _ref_cfg():
    return dataclasses.replace(ref_reduced(ref_get_config("llama-7b")), dtype="float32")


def _run(mesh, ckpt_dir, **kw):
    """train() for STEPS steps: per step (step, loss, grad norm)."""
    out = train_mod.train(_cfg(), SHAPE, steps_total=STEPS, mesh=mesh, ckpt_dir=ckpt_dir,
                          ckpt_every=EVERY, log_every=1, **kw)
    return [(s["step"], s["loss"], s["grad_norm"]) for s in out["steps"]]


def _files(path) -> list:
    n = len(json.loads((Path(path) / "manifest.json").read_text())["leaves"])
    return [np.load(Path(path) / f"leaf{i:05d}.npy") for i in range(n)]


def _whole(t) -> np.ndarray:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()


def ckpt_rank(rank, world, root, ref_ckpt):
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
    from repro_torch.core import gspmd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import fsdp_axes_for, program_for

    root = Path(root)
    writes = []
    write = ckpt._write

    def logged(path, step, host, extra):
        writes.append(os.path.basename(path))
        return write(path, step, host, extra)

    ckpt._write = logged
    meshes = {"data2": Mesh({"data": 2}, device="cpu"),
              "model2": Mesh({"model": 2}, device="cpu")}
    cfg = _cfg()
    out = {"full": _run(meshes["data2"], str(root / "run"))}
    if rank == 0:  # the step-2 checkpoint alone, once per restart
        for name in RESTARTS:
            shutil.copytree(root / "run" / STEP2, root / name / STEP2)
    dist.barrier()
    for name in ("data2", "model2"):
        out[name] = _run(meshes[name], str(root / name))

    def placed(mesh):
        axes = dict(mesh.sizes)
        policy = program_for(cfg, SHAPE).compile(mesh_axes=axes, device="cpu").policy(
            fsdp_axes=fsdp_axes_for(axes))
        params = tf.init_placed_params(cfg, policy, mesh, seed=11)
        return policy, (params, optim.adamw_init(params))

    # step 2 restored: through a placed like tree, and through specs on the mesh
    _, like = placed(meshes["data2"])
    step, got, _ = load_checkpoint(str(root / "run" / STEP2), like)
    out["restored"] = {"data2": (step, [_whole(t) for t in tree.leaves(got)],
                                 sum(hasattr(t, "to_local") and t.to_local().numel() < t.numel()
                                     for t in tree.leaves(got)))}
    policy, _ = placed(meshes["model2"])
    whole = tf.init_params(cfg, seed=11, device="cpu")
    specs = tf.param_specs(cfg, policy, meshes["model2"])
    step, got, _ = load_checkpoint(str(root / "run" / STEP2), (whole, optim.adamw_init(whole)),
                                   shardings=(specs, optim.AdamWState(None, specs, specs)),
                                   mesh=meshes["model2"])
    out["restored"]["model2"] = (step, [_whole(t) for t in tree.leaves(got)],
                                 sum(hasattr(t, "to_local") and t.to_local().numel() < t.numel()
                                     for t in tree.leaves(got)))
    # rank 1 sees a stale listing; rank 0's choice holds on both
    mgr = CheckpointManager(str(root / "run"))
    if rank == 1:
        mgr.all_steps = lambda: [2]
    out["latest"] = mgr.restore_latest(like)[0]
    # the reference's checkpoint onto {model: 2}
    _, like = placed(meshes["model2"])
    step, got, extra = load_checkpoint(ref_ckpt, like)
    out["from_ref"] = (step, extra, [_whole(t) for t in tree.leaves(got)])
    # bfloat16 and int leaves, one of them split unevenly (5 rows on 2 ranks)
    rng = np.random.default_rng(9)
    small = {"w": torch.as_tensor(rng.normal(size=(8, 6))).to(torch.bfloat16),
             "u": torch.as_tensor(rng.normal(size=(5, 3))).to(torch.bfloat16),
             "n": torch.as_tensor(rng.integers(0, 9, size=(4,)), dtype=torch.int32)}
    mesh = meshes["data2"]
    placed_small = {"w": gspmd.distribute(small["w"], mesh, ("data", None)),
                    "u": gspmd.DTensor.from_local(small["u"], mesh.dmesh,
                                                  [gspmd.Replicate()]).redistribute(
                        mesh.dmesh, [gspmd.Shard(0)]),
                    "n": small["n"]}
    save_checkpoint(str(root / "small"), 1, placed_small)
    _, got, _ = load_checkpoint(str(root / "small"), placed_small)
    out["small"] = {k: (bool(torch.equal(gspmd.full(got[k]), small[k])),
                        str(gspmd.full(got[k]).dtype)) for k in small}
    out["writes"] = writes
    return out


@pytest.fixture(scope="module")
def ref_state():
    """The reference's params and AdamW state after one update, saved."""
    params = ref_tf.init_params(_ref_cfg(), jax.random.PRNGKey(4))
    state = ref_optim.adamw_init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.3, params)
    params, state, _ = ref_optim.adamw_update(params, grads, state, 1e-3)
    return params, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref_state):
    root = tmp_path_factory.mktemp("ckptmesh")
    ref_ckpt = root / "ref" / "step_00000007"
    ref_save(str(ref_ckpt), 7, ref_state, extra={"who": "ref"})
    res = spawn(2, ckpt_rank, str(root), str(ref_ckpt), tmpdir=root / "spawn", timeout=600)
    return root, res


@pytest.fixture(scope="module")
def one_rank(ranks):
    """The restart from step 2 on one rank."""
    root, _ = ranks
    return _run(None, str(root / "one"), device="cpu")


def test_restart_on_the_same_mesh_is_bit_equal(ranks):
    _, res = ranks
    full = res[0]["full"]
    assert [s for s, _, _ in full] == [0, 1, 2]
    for rank, r in enumerate(res):
        assert r["full"] == full, rank  # every rank the same losses
        assert r["data2"] == [full[2]], (rank, r["data2"], full[2])


@pytest.mark.parametrize("name", ["model2", "one"])
def test_restart_onto_another_mesh_continues_within_1e_5(name, ranks, one_rank):
    _, res = ranks
    full = res[0]["full"]
    got = [one_rank] if name == "one" else [r[name] for r in res]
    for g in got:
        assert [s for s, _, _ in g] == [2], g
        for k in (1, 2):  # loss, grad norm
            assert abs(g[0][k] - full[2][k]) <= TOL * abs(full[2][k]), (name, g, full[2])


@pytest.mark.parametrize("name", ["data2", "model2"])
def test_restored_leaves_equal_the_saved_ones_bit_for_bit(name, ranks):
    root, res = ranks
    want = _files(root / "run" / STEP2)
    for rank, r in enumerate(res):
        step, leaves, split = r["restored"][name]
        assert step == 2 and len(leaves) == len(want)
        assert split > 0, (name, "no leaf was restored in blocks")
        for i, (g, w) in enumerate(zip(leaves, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, (rank, i)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} rank {rank} leaf {i}")


def test_only_rank_zero_writes(ranks):
    _, res = ranks
    # the uninterrupted run's steps 2 and 3, then each restart's step 3
    assert res[0]["writes"] == [STEP2, "step_00000003"] + ["step_00000003"] * 2 + ["small"]
    assert res[1]["writes"] == []


def test_restore_latest_restores_the_step_rank_zero_chose(ranks):
    _, res = ranks
    assert [r["latest"] for r in res] == [3, 3]


def test_two_rank_checkpoint_loads_in_the_reference(ranks, tmp_path):
    root, _ = ranks
    path = root / "run" / STEP2
    like = ref_tf.init_params(_ref_cfg(), jax.random.PRNGKey(0))
    like = (like, ref_optim.adamw_init(like))
    step, got, extra = ref_load(str(path), like)
    assert step == 2 and extra == {}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        assert g.shape == w.shape and g.dtype == w.dtype
    # the manifest: the keys a checkpoint the reference saves has
    ref_save(str(tmp_path / "ref"), 2, like)
    mine = json.loads((path / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert set(mine) == set(theirs) == {"step", "extra", "leaves"}
    assert [sorted(l) for l in mine["leaves"]] == [sorted(l) for l in theirs["leaves"]]
    assert [(l["shape"], l["dtype"]) for l in mine["leaves"]] == [
        (l["shape"], l["dtype"]) for l in theirs["leaves"]]
    # its parameters, carried into the port, are the files' own
    params = tf.from_reference_params(_cfg(), jax.tree.map(np.asarray, got[0]), device="cpu")
    files = _files(path)
    for i, p in enumerate(tree.leaves(params)):
        np.testing.assert_array_equal(p.numpy(), files[i], err_msg=f"leaf {i}")


def test_reference_checkpoint_restores_onto_two_ranks(ranks, ref_state):
    _, res = ranks
    want = [np.asarray(x) for x in jax.tree.leaves(ref_state)]
    for rank, r in enumerate(res):
        step, extra, leaves = r["from_ref"]
        assert step == 7 and extra == {"who": "ref"} and len(leaves) == len(want)
        for i, (g, w) in enumerate(zip(leaves, want)):
            assert g.dtype == w.dtype, (rank, i)
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank} leaf {i}")


def test_train_cli_on_a_mesh_checkpoints_and_restarts_on_another(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama-7b",
            "--reduced", "--seq", "16", "--batch", "2", "--device", "cpu",
            "--ckpt", str(tmp_path / "ck")]
    first = subprocess.run(base + ["--steps", "2", "--mesh", "data=2"], capture_output=True,
                           text=True, env=env, timeout=300, cwd=ROOT)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "[train] step     1 loss" in first.stdout
    second = subprocess.run(base + ["--steps", "3", "--mesh", "model=2"], capture_output=True,
                            text=True, env=env, timeout=300, cwd=ROOT)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "[train] restored step 2 (elastic reshard onto {'model': 2})" in second.stdout
    assert "[train] step     2 loss" in second.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002", "step_00000003"]


def test_bf16_int_and_uneven_leaves_round_trip_on_two_ranks(ranks):
    """``save_checkpoint`` of DTensor leaves in bfloat16 (one split
    unevenly: 5 rows on 2 ranks) and a plain int32 leaf, restored through
    the placements of the same tree: equal, dtypes kept."""
    _, res = ranks
    for r in res:
        assert r["small"] == {"w": (True, "torch.bfloat16"), "u": (True, "torch.bfloat16"),
                              "n": (True, "torch.int32")}, r["small"]
