"""The engine's compiled bucket prefill and admission, and the compiled
train step, on the CPU, against the reference.

The reference jits its bucket prefill with ``last_index`` traced, its
admission with ``slot`` traced and the caches donated, and its train step
with the parameters and moments donated.  On a card with no mesh the port
captures each as a CUDA graph (``launch.steps.GraphedStep``), which needs
those scalars as 0-d tensors on the device and every input and output in
a fixed buffer.  On the CPU nothing is captured, but the fixed-buffer
plumbing is the card's, so these tests catch what a replay would alias.
Reduced configs, the reference's seeded parameters carried over with
``tf.from_reference_params``, inputs from seeded numpy.  Tolerances:

* ``forward(logit_index=<0-d tensor>)``: bit-equal to the int path, and
  within rtol 1e-4 / atol 1e-5 of the reference's traced index (float32
  sums in another order, as the port's other float32 tests);
* admission: pure copies, so bit-equal to the reference's on the same
  inputs, for every block kind;
* the engine: generations token for token the reference engine's;
* ``train()``: the loss within 1e-4 relative of the reference's
  ``train`` (tests/test_torch_train.py's limit), the learning rate within
  1e-6 of the reference's schedule, the step counter exact;
* bf16 hymba: row 0 of a batch of two within 1e-3 of max|logit| of the
  batch-1 run, in both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402
from repro.serving.paged_kv import make_admit_fn as ref_make_admit_fn  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.paged_kv import make_admit_fn  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype),
            dataclasses.replace(reduced(get_config(arch)), dtype=dtype))


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, tf.from_reference_params(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# logit_index as a device tensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama-7b", "hymba-1.5b"])
def test_forward_tensor_logit_index_equals_int_and_reference(arch):
    """A bucket of 20 tokens read at the last real token (12), at the last
    position and at the first: the tensor index gives the int index's
    logits and caches bit for bit, and the reference's traced index's
    within the float32 tolerance (hymba's window is 16, so its caches
    hold a ring that has wrapped)."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=2)
    toks = _tokens(cfg, 1, 20, seed=3)
    ref_fwd = jax.jit(lambda p, t, i: ref_tf.forward(p, t, ref_cfg, collect_cache=True,
                                                     logit_index=i)[:2])
    for last in (12, 19, 0):
        want, want_caches = ref_fwd(ref_params, jnp.asarray(toks), jnp.int32(last))
        with torch.inference_mode():
            got, caches, _ = tf.forward(params, torch.from_numpy(toks), cfg,
                                        collect_cache=True, logit_index=torch.tensor(last))
            by_int, int_caches, _ = tf.forward(params, torch.from_numpy(toks), cfg,
                                               collect_cache=True, logit_index=last)
        assert got.shape == (1, 1, cfg.vocab_padded)
        assert torch.equal(got, by_int), last
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{arch} logit_index {last}")
        for a, b in zip(tree.leaves(caches), tree.leaves(int_caches)):
            assert torch.equal(a, b)
        for a, w in zip(tree.leaves(caches), jax.tree.leaves(want_caches)):
            np.testing.assert_allclose(_np(a), _np(w), rtol=RTOL, atol=ATOL)


def test_bucket_prefill_step_takes_a_tensor_last_index():
    """``make_bucket_prefill_step`` with the index in a buffer, rewritten
    between calls: each call reads the value the buffer holds then."""
    _, cfg = _cfgs("llama-7b")
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 16, seed=1))
    step = steps.make_bucket_prefill_step(cfg)
    index = torch.zeros((), dtype=torch.long)
    with torch.inference_mode():
        for last in (9, 15, 3):
            index.fill_(last)
            got, _ = step(params, {"tokens": toks}, index)
            want, _ = step(params, {"tokens": toks}, last)
            assert torch.equal(got, want), last


# ---------------------------------------------------------------------------
# admission with slot as a device tensor
# ---------------------------------------------------------------------------

#: one architecture per block kind: attn, hymba, mlstm + slstm
ADMIT_ARCHS = {"llama-7b": {"attn"}, "hymba-1.5b": {"hymba"},
               "xlstm-125m": {"mlstm", "slstm"}}


@pytest.mark.parametrize("arch", sorted(ADMIT_ARCHS))
def test_admission_with_a_tensor_slot_equals_reference(arch):
    """One request's prefill caches (13 tokens) admitted into slot 2 of 3
    under the table row (4, 2, 0) of blocks of 8, into pools and states
    holding seeded random numbers: the port with ``slot`` a 0-d tensor and
    with an int, the reference with ``jnp.int32``, on the same inputs.
    Every pool and state leaf bit-equal, the token buffer seeded at the
    slot in a copy (the buffer passed in is not written)."""
    ref_cfg, cfg = _cfgs(arch)
    assert set(cfg.block_pattern) == ADMIT_ARCHS[arch]
    ref_params, params = _params(ref_cfg, cfg, seed=4)
    batch, n_blocks, blk, s, slot = 3, 7, 8, 13, 2
    rng = np.random.default_rng(4)
    toks = _tokens(cfg, 1, s, seed=5)
    _, ref_pre = ref_steps.make_bucket_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(toks)}, jnp.int32(s - 1))
    with torch.inference_mode():
        _, like_pre = steps.make_bucket_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(toks)}, s - 1)
    pre_np = [np.asarray(x) for x in jax.tree.leaves(ref_pre)]
    ref_like = ref_tf.init_paged_caches(ref_cfg, batch, n_blocks, blk)
    like = tf.init_paged_caches(cfg, batch, n_blocks, blk, device="cpu")
    init_np = [rng.normal(size=x.shape).astype(np.asarray(x).dtype)
               for x in jax.tree.leaves(ref_like)]
    assert [x.shape for x in init_np] == [tuple(t.shape) for t in tree.leaves(like)]
    blocks = np.array([4, 2, 0], np.int32)  # one 0-padded entry: the scratch block
    tok_np = np.array([[7], [8], [9]], np.int32)

    ref_caches, ref_toks = ref_make_admit_fn(ref_cfg)(
        jax.tree.unflatten(jax.tree.structure(ref_like), [jnp.asarray(a) for a in init_np]),
        jax.tree.unflatten(jax.tree.structure(ref_pre), [jnp.asarray(a) for a in pre_np]),
        jnp.asarray(blocks), jnp.int32(slot), jnp.asarray([42], jnp.int32),
        jnp.asarray(tok_np))
    want = [np.asarray(x) for x in jax.tree.leaves(ref_caches)]

    def port(slot_arg):
        it, pit = iter(init_np), iter(pre_np)
        caches = tree.map(lambda _: torch.from_numpy(next(it).copy()), like)
        pre = tree.map(lambda _: torch.from_numpy(pit.__next__().copy()), like_pre)
        tokens = torch.from_numpy(tok_np.copy())
        with torch.inference_mode():
            out, new = make_admit_fn(cfg)(caches, pre, torch.from_numpy(blocks), slot_arg,
                                          torch.tensor([42], dtype=torch.int32), tokens)
        assert out is caches  # written in place
        np.testing.assert_array_equal(tokens.numpy(), tok_np)
        return [t.numpy() for t in tree.leaves(out)], new.numpy()

    for slot_arg in (torch.tensor(slot), slot):
        got, got_toks = port(slot_arg)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got_toks, np.asarray(ref_toks))
    assert got_toks[slot, 0] == 42


# ---------------------------------------------------------------------------
# the engine through its fixed-buffer prefill path
# ---------------------------------------------------------------------------


def _ref_engine(ref_cfg, ref_params, **kw):
    """The reference's engine, its decode step blocking (it mutates the
    host arrays it hands an asynchronous step: tests/test_torch_serving.py)."""
    eng = RefServingEngine(ref_cfg, params=ref_params, **kw)
    decode = eng._decode
    eng._decode = lambda *a: jax.block_until_ready(decode(*a))
    return eng


def test_engine_two_buckets_in_turn_equal_reference_engine():
    """Five requests through two slots, their pow2 buckets 8, 16, 8, 16, 8
    in admission order: each bucket's compiled step (``graph=False`` on
    the CPU, the card's fixed buffers) is made once and called again from
    its buffers, the other bucket's calls between; generations token for
    token the reference engine's, and the eager engine's."""
    ref_cfg, cfg = _cfgs("llama-7b")
    ref_params, params = _params(ref_cfg, cfg, seed=8)
    lens, max_new = (5, 13, 7, 11, 6), (4, 3, 5, 4, 3)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    kw = dict(batch=2, max_seq=24, block=8)
    ref_eng = _ref_engine(ref_cfg, ref_params, **kw)
    got = []
    for graph in (None, False):
        eng = ServingEngine(cfg, params=params, device="cpu", graph=graph, **kw)
        for p, n in zip(prompts, max_new):
            eng.submit(p, n)
        got.append(eng.run()[0])
        assert sorted(k[2] for k in eng._prefills) == [8, 16]
        assert all(run.graphed is False and run.replays == 0
                   for run in eng._prefills.values())
    assert [eng.registry.bucket_len(n) for n in lens] == [8, 16, 8, 16, 8]
    for p, n in zip(prompts, max_new):
        ref_eng.submit(p, n)
    want, _ = ref_eng.run()
    assert sorted(want) == sorted(got[0]) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[0][rid], np.asarray(want[rid]), err_msg=f"rid {rid}")
        np.testing.assert_array_equal(got[1][rid], got[0][rid])


def test_engine_step_log_survives_a_later_admission():
    """Two requests decode two steps; the first leaves, and a third is
    admitted into its slot through the same bucket's step (its second
    call, which a card replays): the tokens logged before are unchanged,
    the engine's token buffer is not the step's fixed output, and the
    third request's generation is its sequential ``serve()``."""
    from repro_torch.launch import serve as port_serve

    _, cfg = _cfgs("llama-7b")
    params = tf.init_params(cfg, seed=5, device="cpu")
    prompts = _tokens(cfg, 3, 10, seed=5)
    eng = ServingEngine(cfg, batch=2, max_seq=32, block=8, params=params, device="cpu")
    for p, n in zip(prompts, (3, 8, 5)):
        eng.submit(p, n)
    with torch.inference_mode():
        eng._admit_phase()
        for _ in range(2):
            eng._decode_phase()
        assert eng.slots[0] is None and eng.slots[1] is not None
        logged = [t.clone() for t in eng._step_log]
        eng._admit_phase()
        (run,) = eng._prefills.values()
        assert eng.slots[0].rid == 2
        assert eng.tokens.data_ptr() not in {o.data_ptr() for o in run.outputs}
        eng._decode_phase()
    assert len(eng._step_log) == 3
    for a, b in zip(eng._step_log, logged):
        assert torch.equal(a, b)
    res, _ = eng.run()
    gen, _ = port_serve.serve(cfg, prompts[2:3], max_new=5, params=params, kv_len=eng.seq,
                              device="cpu")
    np.testing.assert_array_equal(res[2], gen[0])


# ---------------------------------------------------------------------------
# train() through the fixed-buffer step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_train_fixed_buffer_step_matches_reference_train(schedule, monkeypatch):
    """Four steps of ``train()`` on reduced llama (b=2, s=16, peak lr
    1e-3) through its compiled step (the fixed batch buffers and metric
    outputs, ``graph=False`` on the CPU), the reference's weights: the
    losses those of the reference's ``train``, the learning rates its
    schedule's at steps 0-3, the AdamW step counter 4 in both."""
    ref_cfg, cfg = _cfgs("llama-7b")
    ref_params, params = _params(ref_cfg, cfg, seed=0)
    monkeypatch.setattr(train_mod.tf, "init_placed_params",
                        lambda cfg, policy, mesh, seed=0: tree.map(torch.clone, params))
    n, peak = 4, 1e-3
    ref = ref_train.train(ref_cfg, RefShapeConfig("t", "train", 16, 2), steps_total=n,
                          schedule=schedule, peak_lr=peak, log_every=1)
    out = train_mod.train(cfg, ShapeConfig("t", "train", 16, 2), steps_total=n,
                          schedule=schedule, peak_lr=peak, log_every=1, device="cpu")
    assert [s["step"] for s in out["steps"]] == [step for step, _ in ref["history"]] == [0, 1, 2, 3]
    np.testing.assert_allclose([s["loss"] for s in out["steps"]],
                               [loss for _, loss in ref["history"]], rtol=1e-4)
    if schedule == "wsd":
        want_lr = [ref_optim.wsd_schedule(jnp.int32(i), peak_lr=peak, warmup=1, stable=2,
                                          decay=1) for i in range(n)]
    else:
        want_lr = [ref_optim.cosine_schedule(jnp.int32(i), peak_lr=peak, warmup=1, total=n)
                   for i in range(n)]
    np.testing.assert_allclose([s["lr"] for s in out["steps"]],
                               np.asarray(want_lr, np.float32), rtol=1e-6)
    assert int(out["opt_state"].step) == int(ref["opt_state"].step) == n
    assert out["opt_state"].step.dtype == torch.int32


def test_adamw_advances_its_step_counter_in_place():
    """A captured step replays on the same tensors: the counter the update
    returns is the one it was given, one further."""
    params = {"w": torch.ones(3)}
    state = optim.adamw_init(params)
    counter = state.step
    for i in range(3):
        _, state, _ = optim.adamw_update(params, {"w": torch.full((3,), 0.5)}, state, 1e-3)
        assert state.step is counter and int(counter) == i + 1


def test_compiled_train_step_reads_its_buffers_and_writes_its_state():
    """``compiled_train_step`` on the CPU: the second call reads the batch
    copied into its input buffers, writes the parameters in place and
    returns the same fixed metric buffers; both calls equal two calls of
    the plain step on a copy of the state."""
    _, cfg = _cfgs("llama-7b")
    params = tf.init_params(cfg, seed=2, device="cpu")
    twin = tree.map(torch.clone, params)
    step_fn = steps.make_train_step(cfg)
    batches = [{k: torch.from_numpy(_tokens(cfg, 2, 16, seed=10 + i + j))
                for j, k in enumerate(("tokens", "labels"))} for i in range(2)]
    state = optim.adamw_init(params)
    run = train_mod.compiled_train_step(step_fn, params, state, batches[0])
    ptrs = [p.data_ptr() for p in tree.leaves(params)]
    first = run()
    for k, v in batches[1].items():
        run.inputs[k].copy_(v)
    second = run()
    assert second is first and len(second) == len(train_mod.METRICS)
    twin_state = optim.adamw_init(twin)
    for b in batches:
        _, _, want = step_fn(twin, twin_state, b)
    for k, got in zip(train_mod.METRICS, second):
        assert torch.equal(got, want[k]), k
    assert [p.data_ptr() for p in tree.leaves(params)] == ptrs
    for a, b in zip(tree.leaves(params), tree.leaves(twin)):
        assert torch.equal(a, b)
    assert int(state.step) == int(twin_state.step) == 2


def test_train_graph_true_raises_on_the_cpu():
    _, cfg = _cfgs("llama-7b")
    with pytest.raises(ValueError, match="cpu"):
        train_mod.train(cfg, ShapeConfig("t", "train", 16, 2), steps_total=1,
                        device="cpu", graph=True)


# ---------------------------------------------------------------------------
# bf16 hymba and the batch
# ---------------------------------------------------------------------------


def test_bf16_hymba_row_of_a_batch_of_two_equals_batch_one_in_both_packages():
    """Reduced hymba-1.5b in bf16, 24 tokens: row 0 of a batch of two
    against the same row alone, in each package, within 1e-3 of
    max|logit|.  On the CPU neither package's logits move with the batch,
    so a movement on the card comes from its kernels."""
    ref_cfg, cfg = _cfgs("hymba-1.5b", dtype="bfloat16")
    ref_params, params = _params(ref_cfg, cfg, seed=9)
    toks = _tokens(cfg, 2, 24, seed=9)
    ref_fwd = jax.jit(lambda p, t: ref_tf.forward(p, t, ref_cfg)[0])
    with torch.inference_mode():
        port = [tf.forward(params, torch.from_numpy(t), cfg)[0] for t in (toks, toks[:1])]
    runs = {"reference": [_np(ref_fwd(ref_params, jnp.asarray(t))) for t in (toks, toks[:1])],
            "port": [_np(x) for x in port]}
    for name, (two, one) in runs.items():
        scale = float(np.abs(one).max())
        assert np.isfinite(two).all() and scale > 0
        diff = float(np.abs(two[0] - one[0]).max())
        assert diff <= 1e-3 * scale, (name, diff, scale)
