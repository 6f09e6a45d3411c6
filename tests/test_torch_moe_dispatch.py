"""Global MoE dispatch on a mesh whose batch is split: the tokens stay where
the batch is split and move to their experts' ranks by all-to-all
(``models/moe.py``, ``_global_placed`` and ``_dispatch_a2a``).

A reduced qwen2-moe-a2.7b in float32 at capacity factor 1 on 4 x 128
tokens (8 experts, top 2: 128 slots an expert, as many as the entries an
expert gets on average), so full experts drop tokens, on gloo CPU ranks —
one spawn per mesh (``launch.mesh.spawn``, ``file://`` rendezvous under a
pytest tmp path):

  * ``{data: 2}`` under ``{b: data, e: data}``;
  * ``(2, 2)`` under ``{b: data, e: (data, model)}``;
  * ``(2, 2)`` under ``{b: data, s: model, e: (data, model)}``, the
    sequence split too (as the production mesh's (2, 16, 16) splits it).

Held against one rank: every (token, k) entry's global capacity slot
(so the same tokens drop), the logits within TOL x max|logit|, the loss,
the aux loss and every gradient within 1e-5 (of max|g| for a gradient);
and ``moe_ffn`` on the same seeded numpy weights against the reference's
``moe_ffn`` at ``tests/test_torch_moe.py``'s tolerances.

On the dry run's fake process group (``dryrun.abstract_mesh``, meta
blocks), each in a fresh process: the per-rank peak of a train step under
weak scaling (4 and 16 ranks, the global batch 4 x larger at 16) stays
within 1.1 x, with the experts split over the batch's axis and with them
whole; each MoE layer's forward issues two all-to-alls whose rows
are the rank's own tokens, no all-gather of the activations and no
reduction of them; and the abstract all-to-alls, which route every expert
an even share, move what 2 real gloo ranks move between them.
"""
import dataclasses
import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.gspmd import full  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402

B, S = 4, 128
TOL, GRAD_TOL, AUX_TOL = 1e-5, 1e-5, 1e-5
FFN_RTOL, FFN_ATOL = 1e-4, 1e-5  # tests/test_torch_moe.py
CASES = {
    "data2": ({"data": 2}, {"b": "data", "e": "data"}),
    "2x2": ({"data": 2, "model": 2}, {"b": "data", "e": ("data", "model")}),
    "2x2-seq": ({"data": 2, "model": 2},
                {"b": "data", "s": "model", "e": ("data", "model")}),
}
MESHES = {"data2": {"data": 2}, "2x2": {"data": 2, "model": 2}}


def _cfgs(**kw):
    kw = dict(capacity_factor=1.0, **kw)
    return (dataclasses.replace(ref_reduced(ref_get_config("qwen2-moe-a2.7b")), **kw),
            dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), **kw))


def _tokens(cfg, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def _ffn_params(cfg, seed=3):
    """Seeded numpy weights of one MoE layer, the reference's layout."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_e, cfg.d_ff

    def dense(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)

    p = {"router": dense(D, E), "w1": dense(E, D, F), "w2": dense(E, F, D),
         "w3": dense(E, D, F)}
    if cfg.shared_expert_ff:
        H = cfg.shared_expert_ff
        p["shared"] = {"w1": dense(D, H), "w2": dense(H, D), "w3": dense(D, H)}
    return p


def _ffn_input(cfg):
    return np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# what every rank (and the one rank) computes
# ---------------------------------------------------------------------------


class _Slots:
    """The global capacity slot of every (token, k) entry a dispatch
    computed in this process, with the entries' experts: on one rank
    ``_slot_ranks`` of all entries, on a mesh the slots ``_dispatch_a2a``
    is handed for this rank's entries."""

    def __init__(self, mesh: bool):
        self.mesh = mesh

    def __enter__(self):
        from repro_torch.models import moe

        self.got = []
        self._saved = (moe._slot_ranks, moe._dispatch_a2a)
        ranks, a2a = self._saved

        def slot_ranks(e_flat, E):
            r = ranks(e_flat, E)
            self.got.append((e_flat.numpy().copy(), r.numpy().copy()))
            return r

        def dispatch(lp, xt, topw, e_flat, pos, *a):
            self.got.append((e_flat.numpy().copy(), pos.numpy().copy()))
            return a2a(lp, xt, topw, e_flat, pos, *a)

        if self.mesh:
            moe._dispatch_a2a = dispatch
        else:
            moe._slot_ranks = slot_ranks
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._slot_ranks, moe._dispatch_a2a = self._saved


def model_case(params_np, manual, mesh) -> dict:
    """The reduced model's forward (logits, aux, the slots of each layer's
    dispatch) and its loss's gradients, pinned to the parameters'
    placements."""
    from repro_torch.data.synthetic import place_batch
    from repro_torch.models import transformer as tf
    from repro_torch.models.policy import manual_policy

    _, cfg = _cfgs()
    placed = mesh.world_size > 1
    policy, mesh_arg = (manual_policy(manual), mesh) if placed else (None, None)
    params = tf.from_reference_params(cfg, params_np, device="cpu")
    toks = _tokens(cfg)
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    if placed:
        params = tf.place_params(params, cfg, policy, mesh)
        batch = place_batch({"tokens": toks, "labels": toks}, policy, mesh)
    with torch.no_grad(), _Slots(placed) as rec:
        logits, _, aux = tf.forward(params, batch["tokens"], cfg, policy=policy,
                                    mesh=mesh_arg)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = tf.loss_fn(params, batch, cfg, policy=policy, mesh=mesh_arg)
    grads = torch.autograd.grad(loss, leaves)
    if placed:
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
    return {"logits": full(logits).numpy(), "aux": float(full(aux)),
            "loss": float(full(loss).detach()), "slots": rec.got,
            "grads": [full(g).numpy() for g in grads]}


def ffn_case(manual, mesh) -> dict:
    """``moe_ffn`` alone on seeded numpy weights: its output, aux loss and
    the gradients of the output's sum of squares."""
    from repro_torch.core import gspmd
    from repro_torch.models import moe
    from repro_torch.models.policy import manual_policy

    _, cfg = _cfgs()
    p = tree.map(torch.from_numpy, _ffn_params(cfg))
    x = torch.from_numpy(_ffn_input(cfg))
    policy = manual_policy(manual)
    labels = {"router": "a e", "w1": "e a f", "w2": "e f a", "w3": "e a f"}
    p.update({k: gspmd.distribute(p[k], mesh, policy.param_spec(l))
              for k, l in labels.items()})
    p["shared"] = tree.map(lambda w: gspmd.distribute(w, mesh, (None,) * w.ndim),
                           p["shared"])
    x = gspmd.distribute(x, mesh, policy.act_spec("b s a"))
    leaves = [p[k].requires_grad_(True) for k in labels]
    out, aux = moe.moe_ffn(p, x, cfg, policy=policy, mesh=mesh)
    grads = torch.autograd.grad(torch.sum(full(out) ** 2) + aux, leaves)
    grads = [g.redistribute(w.device_mesh, w.placements) for g, w in zip(grads, leaves)]
    return {"out": full(out).detach().numpy(), "aux": float(aux.detach()),
            "grads": [full(g).numpy() for g in grads]}


def rank_battery(rank, world, mesh_id, weights):
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(MESHES[mesh_id], device="cpu")
    coord = dict(mesh.coord)
    out = {}
    for name, (sizes, manual) in CASES.items():
        if sizes == MESHES[mesh_id]:
            out[name] = {"coord": coord, "model": model_case(weights, manual, mesh),
                         "ffn": ffn_case(manual, mesh)}
    return out


@pytest.fixture(scope="module")
def weights():
    ref_cfg, _ = _cfgs()
    return jax.tree.map(np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(2)))


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Both meshes' spawns, started together before one rank runs here."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(MESHES))
    runs = {m: pool.submit(spawn, math.prod(sizes.values()), rank_battery, m, weights,
                           timeout=600, tmpdir=tmp_path_factory.mktemp(f"dispatch{m}"))
            for m, sizes in MESHES.items()}

    def case(name):
        mesh_id = "data2" if name == "data2" else "2x2"
        return [r[name] for r in runs[mesh_id].result()]

    yield case
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_rank(weights, ranks):
    """The model on one rank (plain tensors), while the meshes run, and
    ``moe_ffn``'s gradients there."""
    from repro_torch.models import moe

    _, cfg = _cfgs()
    out = {"model": model_case(weights, None, Mesh({"data": 1}, device="cpu"))}
    p = tree.map(torch.from_numpy, _ffn_params(cfg))
    leaves = [p[k].requires_grad_(True) for k in ("router", "w1", "w2", "w3")]
    y, aux = moe.moe_ffn(p, torch.from_numpy(_ffn_input(cfg)), cfg)
    grads = torch.autograd.grad(torch.sum(y ** 2) + aux, leaves)
    out["ffn"] = {"out": y.detach().numpy(), "aux": float(aux.detach()),
                  "grads": [g.numpy() for g in grads]}
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _local_entries(a, coord, name, K):
    """This rank's (token, k) entries of a one-rank (B*S*K,) array: its
    batch rows and its sequence block, in its (row, position, k) order."""
    sizes, manual = CASES[name]
    a = a.reshape(B, S, K)
    for dim, label in ((0, "b"), (1, "s")):
        axes = manual.get(label)
        if axes:
            axes = (axes,) if isinstance(axes, str) else axes
            n = math.prod(sizes[x] for x in axes)
            idx = 0
            for x in axes:
                idx = idx * sizes[x] + coord[x]
            a = np.take(a, range(idx * a.shape[dim] // n, (idx + 1) * a.shape[dim] // n),
                        axis=dim)
    return a.reshape(-1)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_global_slots_and_drops_equal_one_rank(name, one_rank, ranks):
    """Every rank gives its entries the one-rank global capacity slots —
    its own ranks plus the counts of earlier rows and sequence blocks —
    so the same tokens drop."""
    _, cfg = _cfgs()
    want = one_rank["model"]["slots"]
    C = 128
    assert any((r >= C).any() for _, r in want)  # full experts drop tokens
    for rank, res in enumerate(ranks(name)):
        got = res["model"]["slots"]
        assert len(got) == len(want) == cfg.n_layers
        for (ge, gp), (we, wr) in zip(got, want):
            np.testing.assert_array_equal(ge, _local_entries(we, res["coord"], name, cfg.top_k))
            np.testing.assert_array_equal(gp, _local_entries(wr, res["coord"], name, cfg.top_k),
                                          err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("name", list(CASES))
def test_logits_loss_aux_and_grads_equal_one_rank(name, one_rank, ranks):
    want = one_rank["model"]
    for rank, res in enumerate(ranks(name)):
        got, what = res["model"], f"{name} rank {rank}"
        _close(got["logits"], want["logits"], TOL, what)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), what
        assert got["aux"] == pytest.approx(want["aux"], rel=AUX_TOL), what
        assert len(got["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _close(g, w, GRAD_TOL, f"{what} grad leaf {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_on_a_mesh_equals_reference_and_one_rank(name, one_rank, ranks):
    ref_cfg, cfg = _cfgs()
    jp = jax.tree.map(jnp.asarray, _ffn_params(cfg))
    want, want_aux = ref_moe.moe_ffn(jp, jnp.asarray(_ffn_input(cfg)), ref_cfg)
    one = one_rank["ffn"]
    for rank, res in enumerate(ranks(name)):
        got, what = res["ffn"], f"{name} rank {rank}"
        np.testing.assert_allclose(got["out"], np.asarray(want), rtol=FFN_RTOL,
                                   atol=FFN_ATOL, err_msg=what)
        np.testing.assert_allclose(got["aux"], float(want_aux), rtol=FFN_RTOL,
                                   atol=FFN_ATOL, err_msg=what)
        _close(got["out"], one["out"], TOL, what)
        assert got["aux"] == pytest.approx(one["aux"], rel=AUX_TOL), what
        for i, (g, w) in enumerate(zip(got["grads"], one["grads"])):
            _close(g, w, GRAD_TOL, f"{what} grad {i}")


# ---------------------------------------------------------------------------
# the dry run's fake process group
# ---------------------------------------------------------------------------


def _weak_cfg():
    """Reduced qwen2-moe with 16 experts, so that 16 ranks split them."""
    return dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), n_experts=16,
                               n_experts_padded=16)


def weak_scaling_peaks(manual) -> dict:
    """A train step's per-rank peak on 4 and 16 fake ranks under the policy
    ``manual``, 16 batch rows of 64 positions a rank (so the MoE layers'
    tensors, not attention's, set the peak)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.policy import manual_policy

    out = {}
    for n in (4, 16):
        mesh = dryrun.abstract_mesh((n,), ("data",))
        costs = dryrun.run_abstract(_weak_cfg(), ShapeConfig("t", "train", 64, 16 * n), mesh,
                                    policy_override=manual_policy(manual))[0]
        out[n] = costs["memory"]["peak"]
    return out


def moe_collectives() -> dict:
    """Reduced qwen2-moe's prefill step (b=8, s=64) on a fake 4-rank data
    axis under {b: data, e: data}: every collective the MoE layers issued,
    as (kind, result bytes, dtype), in order."""
    import traceback

    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.models.policy import manual_policy

    seen = []
    record = hlo_analysis.CollectiveLog.record

    def tap(self, func, args, out):
        found = hlo_analysis.collective_of(func, args, out)
        if found and any(f.filename.endswith("models/moe.py")
                         for f in traceback.extract_stack()):
            seen.append((found[0], found[1], str(out.dtype)))
        return record(self, func, args, out)

    hlo_analysis.CollectiveLog.record = tap
    try:
        _, cfg = _cfgs()
        mesh = dryrun.abstract_mesh((4,), ("data",))
        dryrun.run_abstract(cfg, ShapeConfig("p", "prefill", 64, 8), mesh,
                            policy_override=manual_policy({"b": "data", "e": "data"}))
    finally:
        hlo_analysis.CollectiveLog.record = record
    return {"seen": seen, "n_layers": cfg.n_layers, "d": cfg.d_model, "k": cfg.top_k,
            "e": cfg.n_e}


A2A_CELL = ("train", 32, 4)


def abstract_a2a_cell() -> dict:
    """Reduced qwen2-moe's train step (b=4, s=32, capacity factor 1.25: no
    expert fills its slots) on a fake 2-rank data axis under {b: data,
    e: data}."""
    from repro_torch.launch import dryrun
    from repro_torch.models.policy import manual_policy

    mesh = dryrun.abstract_mesh((2,), ("data",), device="cpu")
    costs = dryrun.run_abstract(reduced(get_config("qwen2-moe-a2.7b")),
                                ShapeConfig("t", *A2A_CELL), mesh,
                                policy_override=manual_policy({"b": "data", "e": "data"}))[0]
    return costs["collectives"].summary()


def real_a2a_rank(rank, world) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.models.policy import manual_policy

    mesh = Mesh({"data": 2}, device="cpu")
    step, args, _, _, _ = dryrun.build_cell(
        reduced(get_config("qwen2-moe-a2.7b")), ShapeConfig("t", *A2A_CELL), mesh,
        policy_override=manual_policy({"b": "data", "e": "data"}), abstract=False)
    return dryrun.measure_step(step, args)["collectives"].summary()


def _fresh(fn, *args):
    """``fn(*args)`` in a new process: the fake process group is this
    process's only one."""
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(fn, *args).result(timeout=600)


def test_per_rank_peak_stays_flat_under_weak_scaling():
    """Four times the ranks and four times the global batch: each rank
    holds as much as before (the layout that gathered the global batch on
    every rank grew with it)."""
    peaks = _fresh(weak_scaling_peaks, {"b": "data", "e": "data"})
    assert peaks[16] <= 1.1 * peaks[4], peaks


def test_per_rank_peak_stays_flat_under_weak_scaling_with_experts_whole():
    """The same under {b: data}: every rank holds all the experts and runs
    its own tokens through them, in capacity buffers of its own tokens'
    size, not the global batch's capacity."""
    peaks = _fresh(weak_scaling_peaks, {"b": "data"})
    assert peaks[16] <= 1.1 * peaks[4], peaks


def test_moe_forward_moves_local_tokens_by_two_all_to_alls():
    got = _fresh(moe_collectives)
    seen, L, D, K, E = (got[k] for k in ("seen", "n_layers", "d", "k", "e"))
    t_loc = 8 * 64 // 4
    a2a = [b for kind, b, _ in seen if kind == "all-to-all"]
    assert len(a2a) == 2 * L, seen
    # the abstract run routes evenly: each exchange carries the rank's own
    # T_loc x K rows, not the global batch's
    assert a2a == [t_loc * K * D * 4] * (2 * L), seen
    for kind, nbytes, dtype in seen:
        if kind == "all-gather":  # the int32 counts of each row's entries, or
            # the router's weight (its expert dim stored on data), never x
            assert (dtype, nbytes) in (("torch.int32", 8 * E * 4),
                                       ("torch.float32", D * E * 4)), seen
        assert kind in ("all-gather", "all-to-all", "all-reduce"), seen
        if kind == "all-reduce":  # only the aux loss's 2E sums
            assert nbytes == 2 * E * 4, seen


def test_abstract_all_to_alls_move_what_real_ranks_move(tmp_path):
    """The abstract run's all-to-alls route every expert an even share; two
    real gloo ranks route by their data, but with no token dropped the rows
    they exchange sum to the even routing's on both ranks.  Every other
    collective, and every count, is equal."""
    real = spawn(2, real_a2a_rank, tmpdir=tmp_path, timeout=600)
    abstract = _fresh(abstract_a2a_cell)
    assert abstract["all-to-all"]["count"] >= 4
    assert set(abstract) == set(real[0]) == set(real[1])
    for kind in abstract:
        for r in real:
            assert r[kind]["count"] == abstract[kind]["count"], (kind, r, abstract)
        if kind == "all-to-all":
            moved = sum(r[kind]["bytes"] for r in real)
            assert moved == 2 * abstract[kind]["bytes"], (real, abstract)
            assert real[0][kind]["bytes"] != real[1][kind]["bytes"]  # routed by data
        else:
            for r in real:
                assert r[kind]["bytes"] == abstract[kind]["bytes"], (kind, r, abstract)
