"""The port's training slice against the reference: the optimizer and its
schedules, the synthetic data, checkpoints (one format, readable by both
packages), the model loss, the train step, the train CLI and the
cost-honesty trajectory.

The same numpy inputs, made from a seeded generator, go through both
packages.  Tolerances, float32 throughout (bf16 is not compared across
frameworks: XLA rounds a fused chain once, torch after every op):
  * the optimizer and schedules: the same float32 formulas, but the
    global norm sums in another order, so rtol 1e-5 (atol 1e-7);
  * the loss and the 3-step loss curve of reduced llama: 1e-4 relative
    (the forward and backward sum in another order);
  * data and checkpoints: bit for bit;
  * the trajectory: equal (pure Python).
"""
import dataclasses
import os
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
from repro.data.synthetic import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch import trajectory as ref_trajectory  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.common import softmax_xent as ref_softmax_xent  # noqa: E402
from repro.optim.adamw import compress_grads as ref_compress  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, batch_shardings  # noqa: E402
from repro_torch.launch import steps, trajectory  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import softmax_xent  # noqa: E402
from repro_torch.optim.adamw import compress_grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(dtype="float32"):
    return (dataclasses.replace(ref_reduced(ref_get_config("llama-7b")), dtype=dtype),
            dataclasses.replace(reduced(get_config("llama-7b")), dtype=dtype))


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    tree_np = jax.tree.map(np.asarray, ref_params)
    return ref_params, tf.from_reference_params(cfg, tree_np, device="cpu")


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": [rng.normal(size=(3, 4)).astype(np.float32) * scale,
                  rng.normal(size=(5,)).astype(np.float32) * scale],
            "a": rng.normal(size=(2, 3, 2)).astype(np.float32) * scale}


def _to_torch(t):
    return tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _assert_tree_close(got, want, rtol=1e-5, atol=1e-7):
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# optimizer, schedules, data
# ---------------------------------------------------------------------------


def test_tree_leaves_follow_jax_flatten_order():
    t = _np_tree(0)
    state = optim.AdamWState(np.int32(3), t, t)
    for got, want in zip(tree.leaves(state), jax.tree.leaves(ref_optim.AdamWState(
            jnp.int32(3), t, t))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _np_tree(1, scale=2.0)
    got, norm = optim.clip_by_global_norm(_to_torch(g), max_norm)
    want, ref_norm = ref_optim.clip_by_global_norm(g, max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference_over_steps(weight_decay):
    """Three updates of a small tree, the lr from the cosine schedule:
    params, moments, step and grad norm after each."""
    params, ref_params = _to_torch(_np_tree(2)), _np_tree(2)
    state, ref_state = optim.adamw_init(params), ref_optim.adamw_init(ref_params)
    sched = dict(peak_lr=1e-2, warmup=1, total=3)
    for i in range(3):
        g = _np_tree(10 + i, scale=0.7)
        lr = optim.cosine_schedule(state.step, **sched)
        ref_lr = ref_optim.cosine_schedule(ref_state.step, **sched)
        params, state, gn = optim.adamw_update(params, _to_torch(g), state, lr,
                                               weight_decay=weight_decay)
        ref_params, ref_state, ref_gn = ref_optim.adamw_update(
            ref_params, g, ref_state, ref_lr, weight_decay=weight_decay)
        assert int(state.step) == int(ref_state.step) == i + 1
        assert state.step.dtype == torch.int32
        np.testing.assert_allclose(float(gn), float(ref_gn), rtol=1e-6)
        _assert_tree_close(params, ref_params)
        _assert_tree_close(state.m, ref_state.m)
        _assert_tree_close(state.v, ref_state.v)
    for leaf in tree.leaves(state.m) + tree.leaves(state.v):
        assert leaf.dtype == torch.float32


def test_adamw_writes_params_and_moments_in_place():
    params = _to_torch(_np_tree(3))
    ptrs = [t.data_ptr() for t in tree.leaves(params)]
    state = optim.adamw_init(params)
    mptrs = [t.data_ptr() for t in tree.leaves(state.m)]
    params2, state2, _ = optim.adamw_update(params, _to_torch(_np_tree(4)), state, 1e-3)
    assert [t.data_ptr() for t in tree.leaves(params2)] == ptrs
    assert [t.data_ptr() for t in tree.leaves(state2.m)] == mptrs


def test_compress_grads_rounds_to_bf16_within_its_noise():
    """bf16 stochastic rounding: each value within 2^-9 |g| (noise) plus one
    bf16 rounding of its original, as in the reference (whose noise comes
    from jax.random, so the bits differ)."""
    g = _np_tree(5)
    got = compress_grads(_to_torch(g), torch.Generator().manual_seed(0))
    want = ref_compress(g, jax.random.PRNGKey(0))
    for a, b, x in zip(tree.leaves(got), jax.tree.leaves(want), tree.leaves(g)):
        assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16"
        bound = (2.0 ** -9 + 2.0 ** -8) * np.abs(x) * 1.01
        assert (np.abs(a.float().numpy() - x) <= bound).all()


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_reference(name):
    if name == "cosine":
        kw = dict(peak_lr=3e-4, warmup=3, total=20)
        fn, ref_fn = optim.cosine_schedule, ref_optim.cosine_schedule
    else:
        kw = dict(peak_lr=3e-4, warmup=2, stable=10, decay=4)
        fn, ref_fn = optim.wsd_schedule, ref_optim.wsd_schedule
    got = [float(fn(s, **kw)) for s in range(25)]
    want = [float(ref_fn(s, **kw)) for s in range(25)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_synthetic_batches_are_bit_equal():
    for seed in (0, 3):
        a, b = SyntheticLM(512, 32, 4, seed=seed), RefSyntheticLM(512, 32, 4, seed=seed)
        for step in (0, 1, 17):
            got, want = a.global_batch_at(step), b.global_batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(a.host_batch_at(step, 1, 2)["tokens"],
                                          b.host_batch_at(step, 1, 2)["tokens"])


class _Mesh:
    def __init__(self, world):
        self.world_size, self.device = world, torch.device("cpu")
        self.sizes = {"data": world}


def test_batch_placement_and_train_step_raise_past_one_rank(capsys):
    """Placement and the train step past one rank are ported: the batch's
    placements are the reference's specs (``"b s"``, ``pos`` unplaced) as
    DTensor placements, and ``make_train_step`` builds on a mesh of two
    ranks (tests/test_torch_gspmd.py runs it against the one-rank step).
    The MoE, hymba and xLSTM configs, which raised on such a mesh before,
    build theirs too, and every one of their parameters and decode-cache
    leaves (the recurrent states included) has placements on it
    (tests/test_torch_blocks_mesh.py runs them against one rank).
    ``pp=2`` prints the reference's static pipeline summary, then trains
    on the unpipelined plan."""
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.train import _print_pipeline_summary as ref_summary
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.policy import manual_policy

    pol = manual_policy({"b": "data", "a": "data"})
    assert batch_shardings(pol, _Mesh(1).sizes, {"tokens": (8, 16), "labels": (8, 16)}) == {
        "tokens": (Replicate(),), "labels": (Replicate(),)}
    assert batch_shardings(pol, _Mesh(4).sizes, {
        "tokens": (8, 16), "prefix_embeds": (8, 4, 32), "pos": ()}) == {
        "tokens": (Shard(0),), "prefix_embeds": (Shard(0),), "pos": None}
    assert batch_shardings(pol, _Mesh(4).sizes, {"tokens": (2, 16)}) == {
        "tokens": (Replicate(),)}  # 2 rows on 4 ranks: safe_spec drops data
    ref_cfg, cfg = _cfgs()
    assert callable(steps.make_train_step(cfg, mesh=_Mesh(2)))
    for arch in ("mixtral-8x7b", "hymba-1.5b", "xlstm-125m"):
        acfg = reduced(get_config(arch))
        assert callable(steps.make_train_step(acfg, policy=pol, mesh=_Mesh(2)))
        for tree_of in (tf.param_shardings(acfg, pol, _Mesh(2).sizes),
                        tf.cache_shardings(acfg, 8, 16, pol, _Mesh(2).sizes)):
            leaves = tree.leaves(tree_of)
            assert leaves and all(isinstance(p, (Shard, Replicate)) for p in leaves)
            assert Shard(1) in leaves  # "L b ..." and "L a ...": the batch, d_model
    capsys.readouterr()
    out = train_mod.train(cfg, ShapeConfig("t", "train", 16, 2), steps_total=1,
                          pp=2, microbatches=2, device="cpu")
    ours = [ln for ln in capsys.readouterr().out.splitlines()
            if "pipeline" in ln or "stage" in ln]
    ref_summary(ref_cfg, RefShape("t", "train", 16, 2), {"data": 1, "model": 1}, 2, 2)
    assert ours == capsys.readouterr().out.splitlines()
    assert ours[0].startswith("[train] pipeline (static): p=2 m=2")
    assert np.isfinite(out["steps"][0]["loss"])


# ---------------------------------------------------------------------------
# checkpoints: one format for both packages
# ---------------------------------------------------------------------------


def _opt_state_after_one_step(params, seed):
    """An AdamW state with non-zero moments and step 1."""
    state = optim.adamw_init(params)
    grads = tree.map(lambda p: torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(p.shape)).astype(np.float32)).to(p.dtype), params)
    return optim.adamw_update(params, grads, state, 1e-3)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_cfg, cfg = _cfgs()
    ref_params, _ = _params(ref_cfg, cfg, seed=1)
    ref_state = ref_optim.adamw_init(ref_params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.3, ref_params)
    ref_params, ref_state, _ = ref_optim.adamw_update(ref_params, grads, ref_state, 1e-3)
    ref_save(str(tmp_path / "ck"), 7, (ref_params, ref_state), extra={"who": "ref"})
    like_params = tf.init_params(cfg, seed=9, device="cpu")
    like = (like_params, optim.adamw_init(like_params))
    step, (params, state), extra = load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 7 and extra == {"who": "ref"}
    assert isinstance(state, optim.AdamWState) and state.step.dtype == torch.int32
    got, want = tree.leaves((params, state)), jax.tree.leaves((ref_params, ref_state))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_cfg, cfg = _cfgs()
    ref_like, _ = _params(ref_cfg, cfg, seed=2)
    params = tf.init_params(cfg, seed=3, device="cpu")
    params, state, _ = _opt_state_after_one_step(params, seed=4)
    save_checkpoint(str(tmp_path / "ck"), 5, (params, state))
    step, restored, _ = ref_load(str(tmp_path / "ck"),
                                 (ref_like, ref_optim.adamw_init(ref_like)))
    assert step == 5
    for a, b in zip(jax.tree.leaves(restored), tree.leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bf16_checkpoint_is_widened_on_disk_and_restores_bit_equal(tmp_path):
    _, cfg = _cfgs("bfloat16")
    params = tf.init_params(cfg, seed=0, device="cpu")
    params, state, _ = _opt_state_after_one_step(params, seed=1)
    save_checkpoint(str(tmp_path / "ck"), 1, (params, state))
    arr = np.load(tmp_path / "ck" / "leaf00000.npy")
    assert arr.dtype == np.float32
    like = (tf.init_params(cfg, seed=5, device="cpu"),
            optim.adamw_init(tf.init_params(cfg, seed=5, device="cpu")))
    _, restored, _ = load_checkpoint(str(tmp_path / "ck"), like)
    for a, b in zip(tree.leaves(restored), tree.leaves((params, state))):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_manager_saves_async_keeps_the_last_n_and_restores(tmp_path):
    _, cfg = _cfgs()
    params = tf.init_params(cfg, seed=0, device="cpu")
    state = optim.adamw_init(params)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.restore_latest((params, state)) is None
    for s in (1, 2, 3):
        mgr.save(s, (params, state), extra={"s": s})
        # the host copy is taken now: later in-place writes do not reach it
        with torch.no_grad():
            params["final_norm"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    step, (p2, _), extra = mgr.restore_latest((params, state))
    assert step == 3 and extra == {"s": 3}
    torch.testing.assert_close(p2["final_norm"], params["final_norm"] - 1.0)


# ---------------------------------------------------------------------------
# the model loss and the train step
# ---------------------------------------------------------------------------


def test_softmax_xent_matches_reference_with_padded_vocab():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 7, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    for vocab_real in (None, 33):
        got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), vocab_real)
        want = ref_softmax_xent(logits, labels, vocab_real)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _batch(cfg, b=2, s=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def test_loss_fn_matches_reference():
    ref_cfg, cfg = _cfgs()
    ref_params, params = _params(ref_cfg, cfg)
    batch = _batch(cfg)
    loss, met = tf.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    ref_loss, ref_met = ref_tf.loss_fn(ref_params, batch, ref_cfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(float(met["ce"]), float(ref_met["ce"]), rtol=1e-4)
    assert float(met["aux"]) == float(ref_met["aux"]) == 0.0


def test_remat_choices_give_equal_losses_and_gradients():
    _, cfg = _cfgs()
    params = tf.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    res = {}
    for remat in (False, True, "dots"):
        loss, _ = tf.loss_fn(params, batch, cfg, remat=remat)
        res[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in (True, "dots"):
        assert torch.equal(res[remat][0], res[False][0])
        for a, b in zip(res[remat][1], res[False][1]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        tf.loss_fn(params, batch, cfg, remat="everything")


def test_remat_dots_keeps_the_products_and_true_recomputes_them():
    """The backward's matrix products, counted at the dispatcher: ``"dots"``
    runs only the backward's own (the forward's are kept, as
    ``dots_saveable``), ``True`` also recomputes the forward's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountProducts(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    _, cfg = _cfgs()
    params = tf.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    counts = {}
    for remat in (False, True, "dots"):
        loss, _ = tf.loss_fn(params, batch, cfg, remat=remat)
        with CountProducts() as c:
            torch.autograd.grad(loss, leaves)
        counts[remat] = c.n
    assert counts["dots"] == counts[False] < counts[True], counts


def test_train_steps_match_the_reference_loss_curve():
    """Three steps of make_train_step on reduced llama against the
    reference's jitted one: the same weights, batches and schedule."""
    ref_cfg, cfg = _cfgs()
    ref_params, params = _params(ref_cfg, cfg, seed=3)
    sched = dict(peak_lr=1e-3, warmup=1, total=3)
    step = steps.make_train_step(cfg, lr_fn=lambda s: optim.cosine_schedule(s, **sched))
    ref_step = jax.jit(ref_steps.make_train_step(
        ref_cfg, lr_fn=lambda s: ref_optim.cosine_schedule(s, **sched)))
    state, ref_state = optim.adamw_init(params), ref_optim.adamw_init(ref_params)
    data = SyntheticLM(cfg.vocab, 32, 2, seed=0)
    for i in range(3):
        hb = data.global_batch_at(i)
        params, state, met = step(params, state, {k: torch.from_numpy(v)
                                                  for k, v in hb.items()})
        ref_params, ref_state, ref_met = ref_step(ref_params, ref_state, hb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(ref_met[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    _assert_tree_close(params, ref_params, rtol=1e-4, atol=1e-6)


def test_train_restarts_from_its_checkpoint(tmp_path):
    """train() twice on one checkpoint directory: the second run restores
    the first's last step and continues on the same batches."""
    _, cfg = _cfgs()
    shape = ShapeConfig("t", "train", 16, 2)
    kw = dict(ckpt_dir=str(tmp_path / "ck"), plan_cache=str(tmp_path / "plans.json"),
              device="cpu", log_every=1)
    full = train_mod.train(cfg, shape, steps_total=4, device="cpu", log_every=1)
    first = train_mod.train(cfg, shape, steps_total=2, **kw)
    assert [s["step"] for s in first["steps"]] == [0, 1]
    second = train_mod.train(cfg, shape, steps_total=4, **kw)
    assert [s["step"] for s in second["steps"]] == [2, 3]
    np.testing.assert_allclose([s["loss"] for s in first["steps"] + second["steps"]],
                               [s["loss"] for s in full["steps"]], rtol=1e-6)
    assert all(s["wall_s"] > 0 for s in full["steps"])


def test_train_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama-7b",
         "--reduced", "--steps", "2", "--seq", "32", "--batch", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[train] step     1 loss" in out.stdout


def test_train_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "llama-7b", "--reduced", "--steps", "1", "--seq", "16",
                        "--batch", "2"])


# ---------------------------------------------------------------------------
# the cost-honesty trajectory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_trajectory.FAMILIES)
def test_family_ratio_equals_the_reference(arch):
    assert trajectory.FAMILIES == ref_trajectory.FAMILIES
    assert trajectory.family_ratio(arch) == ref_trajectory.family_ratio(arch)
