"""The rest of the model zoo against the reference, on the CPU: hymba's
selective SSM, xLSTM's mLSTM/sLSTM blocks and paligemma's prefix
embeddings.

Reduced configs in float32 (the reference's ``reduced()``: hymba window
16, ssm_state 8; paligemma prefix 4); the reference's seeded parameters
carried over with ``tf.from_reference_params``; inputs from seeded numpy.
Tolerances, each stated where it is used:

* the block functions and ``forward`` logits: rtol 1e-4 / atol 1e-5, the
  port's other float32 tests' (sums in another order; the SSM's
  doubling scan combines in another order than XLA's associative scan,
  and the sLSTM's input projection is one product over all positions
  where the reference takes one per step);
* ``loss_fn``: rtol 1e-5; its gradients: 1e-4 x the largest |g| of each
  leaf (the backward sums over every position in another order);
* the port's teacher-forced decode against its own ``forward``: 1e-4 /
  1e-5 (the reference's own test holds its pair at 2e-2);
* generations of ``serve()`` and of the engine: token for token.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.models.common import ParamFactory as RefParamFactory  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import ssm, xlstm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCHS = ("hymba-1.5b", "xlstm-125m", "paligemma-3b")
RTOL, ATOL = 1e-4, 1e-5


def _cfgs(arch):
    return ref_reduced(ref_get_config(arch)), reduced(get_config(arch))


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, tf.from_reference_params(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _prefix(cfg, b, seed=0):
    return np.random.default_rng(seed + 100).normal(
        size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the block functions
# ---------------------------------------------------------------------------

# (init, forward, init_state, decode) of each block in both packages
BLOCKS = {
    "ssm": ("hymba-1.5b",
            (ref_ssm.init_ssm, ref_ssm.ssm_forward,
             lambda c, b: ref_ssm.init_ssm_state(c, b, jnp.float32), ref_ssm.ssm_decode),
            (ssm.ssm_forward, ssm.ssm_decode)),
    "mlstm": ("xlstm-125m",
              (ref_xlstm.init_mlstm, ref_xlstm.mlstm_forward, ref_xlstm.init_mlstm_state,
               ref_xlstm.mlstm_decode),
              (xlstm.mlstm_forward, xlstm.mlstm_decode)),
    "slstm": ("xlstm-125m",
              (ref_xlstm.init_slstm, ref_xlstm.slstm_forward, ref_xlstm.init_slstm_state,
               ref_xlstm.slstm_decode),
              (xlstm.slstm_forward, xlstm.slstm_decode)),
}


def _block_setup(name, seed=0, b=2, s=32):
    arch, (init, *_), _ = BLOCKS[name]
    ref_cfg, cfg = _cfgs(arch)
    p = init(RefParamFactory(jax.random.PRNGKey(seed), jnp.float32, False), ref_cfg)
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, p, tp, x


def _chunk_kw(name):
    return {} if name == "slstm" else {"chunk": 8}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_forward_matches_reference(name):
    """s = 32 in chunks of 8, so the carry crosses three chunk boundaries;
    the output and every leaf of the final state at 1e-4 / 1e-5."""
    ref_cfg, cfg, p, tp, x = _block_setup(name)
    _, (_, ref_fwd, _, _), (fwd, _) = BLOCKS[name]
    want, want_st = ref_fwd(p, jnp.asarray(x), ref_cfg, **_chunk_kw(name))
    got, st = fwd(tp, torch.from_numpy(x), cfg, **_chunk_kw(name))
    _close(got, want, what="output")
    assert type(st).__name__ == type(want_st).__name__
    for field, g, w in zip(st._fields, st, want_st):
        assert g.shape == w.shape, field
        _close(g, w, what=field)


def test_ragged_last_chunk_computes_the_same_function():
    """The port lets the last chunk be short (s = 30 in chunks of 8); the
    reference, which asserts whole chunks, gives the same function in one
    chunk of 30."""
    for name in ("ssm", "mlstm"):
        ref_cfg, cfg, p, tp, x = _block_setup(name, s=30)
        _, (_, ref_fwd, _, _), (fwd, _) = BLOCKS[name]
        want, want_st = ref_fwd(p, jnp.asarray(x), ref_cfg, chunk=30)
        got, st = fwd(tp, torch.from_numpy(x), cfg, chunk=8)
        _close(got, want, what=name)
        for g, w in zip(st, want_st):
            _close(g, w, what=name)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_decode_matches_reference(name):
    """Three one-token steps from the state a 32-position forward left, in
    both packages; outputs and states at 1e-4 / 1e-5."""
    ref_cfg, cfg, p, tp, x = _block_setup(name, seed=1, s=35)
    _, (_, ref_fwd, _, ref_dec), (fwd, dec) = BLOCKS[name]
    _, rst = ref_fwd(p, jnp.asarray(x[:, :32]), ref_cfg, **_chunk_kw(name))
    _, st = fwd(tp, torch.from_numpy(x[:, :32]), cfg, **_chunk_kw(name))
    for t in range(32, 35):
        want, rst = ref_dec(p, jnp.asarray(x[:, t:t + 1]), rst, ref_cfg)
        got, st = dec(tp, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        _close(got, want, what=f"step {t}")
        for g, w in zip(st, rst):
            _close(g, w, what=f"state at step {t}")


def test_decode_from_initial_state_matches_reference():
    """The first decode step from the initial states (m = -inf): finite and
    the reference's."""
    for name in sorted(BLOCKS):
        ref_cfg, cfg, p, tp, x = _block_setup(name, seed=2, s=1)
        arch, (_, _, ref_init, ref_dec), (_, dec) = BLOCKS[name]
        init = {"ssm": lambda: ssm.init_ssm_state(cfg, 2, torch.float32),
                "mlstm": lambda: xlstm.init_mlstm_state(cfg, 2),
                "slstm": lambda: xlstm.init_slstm_state(cfg, 2)}[name]
        want, _ = ref_dec(p, jnp.asarray(x), ref_init(ref_cfg, 2), ref_cfg)
        got, st = dec(tp, torch.from_numpy(x), init(), cfg)
        assert all(bool(torch.isfinite(t).all()) for t in st)
        _close(got, want, what=name)


# ---------------------------------------------------------------------------
# the model stack
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=24, seed=0):
    toks = _tokens(cfg, b, s, seed)
    batch = {"tokens": toks, "labels": toks}
    if cfg.prefix_len:
        batch["prefix_embeds"] = _prefix(cfg, b, seed)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    """Full logits and the collected caches (paligemma with its prefix
    embeddings, so the logits cover prefix + tokens); s = 24 runs past
    hymba's window of 16."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg)
    batch = _batch(cfg)
    pe = batch.get("prefix_embeds")
    want, want_caches, _ = ref_tf.forward(
        ref_params, jnp.asarray(batch["tokens"]), ref_cfg,
        prefix_embeds=None if pe is None else jnp.asarray(pe), collect_cache=True,
        remat=False)
    with torch.inference_mode():
        got, caches, _ = tf.forward(
            params, torch.from_numpy(batch["tokens"]), cfg,
            prefix_embeds=None if pe is None else torch.from_numpy(pe), collect_cache=True)
    assert got.shape == want.shape == (2, 24 + cfg.prefix_len, cfg.vocab_padded)
    _close(got, want, what="logits")
    got_leaves = tree.leaves(caches)
    want_leaves = jax.tree.leaves(want_caches)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        _close(g, w, what="caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` (paligemma with the prefix, whose positions predict
    nothing) and every gradient leaf against ``jax.grad``; every gradient
    finite (the xLSTM stabilizers start at -inf)."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=3)
    batch = _batch(cfg, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, _), want_g = jax.value_and_grad(ref_tf.loss_fn, has_aux=True)(
        ref_params, jb, ref_cfg)
    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tf.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, want, rtol=1e-5, atol=0, what="loss")
    want_leaves = jax.tree.leaves(want_g)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        assert bool(torch.isfinite(g).all())
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12)


def test_loss_drops_the_prefix_positions():
    """paligemma's loss is the cross-entropy over the token logits only:
    the same value from ``forward``'s logits with the prefix rows cut."""
    _, cfg = _cfgs("paligemma-3b")
    params = tf.init_params(cfg, seed=4, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=4).items()}
    with torch.no_grad():
        loss, met = tf.loss_fn(params, batch, cfg, remat=False)
        logits, _, _ = tf.forward(params, batch["tokens"], cfg,
                                  prefix_embeds=batch["prefix_embeds"])
    from repro_torch.models.common import softmax_xent

    want = softmax_xent(logits[:, cfg.prefix_len:-1], batch["labels"][:, 1:], cfg.vocab)
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("arch,T", [("hymba-1.5b", 40), ("xlstm-125m", 12),
                                    ("paligemma-3b", 12)])
def test_teacher_forced_decode_equals_forward(arch, T):
    """Decode from empty caches, one token at a time, reproduces the
    port's own full forward at every position (hymba at 40 > 2x its
    window of 16, so the ring buffer wraps twice)."""
    _, cfg = _cfgs(arch)
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, T, seed=5))
    with torch.inference_mode():
        full, _, _ = tf.forward(params, toks, cfg)
        caches = tf.init_caches(cfg, 2, cfg.window or T, device="cpu")
        outs = [tf.decode_step(params, toks[:, t:t + 1], caches, t, cfg)[0][:, 0]
                for t in range(T)]
    _close(torch.stack(outs, dim=1), full)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_and_decode_match_reference(arch):
    """``make_prefill_step`` (with prefix embeddings for paligemma: the
    batch passes them through), ``prepare_decode_caches`` and three
    teacher-forced decode steps of both packages; prompt 20 > hymba's
    window, so its KV is ring-packed beside its SSM state."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=2)
    b, s, n = 2, 20, 3
    batch = {"tokens": _tokens(cfg, b, s, seed=6)}
    if cfg.prefix_len:
        batch["prefix_embeds"] = _prefix(cfg, b, seed=6)
    span = s + cfg.prefix_len
    kv_len = ref_cfg.kv_len(ref_serve.ShapeConfig("x", "decode", span + n + 1, b))
    ref_logits, ref_caches = ref_steps.make_prefill_step(ref_cfg)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref_caches = ref_serve.prepare_decode_caches(ref_cfg, ref_caches, span, kv_len)
    with torch.inference_mode():
        logits, caches = steps.make_prefill_step(cfg)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
        caches = port_serve.prepare_decode_caches(cfg, caches, span, kv_len)
    _close(logits, ref_logits, what="prefill")
    got_leaves, want_leaves = tree.leaves(caches), jax.tree.leaves(ref_caches)
    assert [tuple(g.shape) for g in got_leaves] == [w.shape for w in want_leaves]
    for g, w in zip(got_leaves, want_leaves):
        _close(g, w, what="decode caches")
    ref_decode, decode = ref_steps.make_serve_step(ref_cfg), steps.make_serve_step(cfg)
    tok = np.asarray(jnp.argmax(ref_logits[:, -1], axis=-1))[:, None].astype(np.int32)
    for i in range(n):
        ref_logits, ref_caches = ref_decode(ref_params, jnp.asarray(tok), ref_caches,
                                            jnp.int32(span + i))
        with torch.inference_mode():
            logits, caches = decode(params, torch.from_numpy(tok), caches, span + i)
        _close(logits, ref_logits, what=f"decode step {i}")
        tok = np.asarray(jnp.argmax(ref_logits[:, -1], axis=-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generations_equal_reference(arch):
    """``serve()`` from tokens only, as the reference serves paligemma;
    prompt 20 runs past hymba's window."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    prompts = _tokens(cfg, 3, 20, seed=2)
    want, _ = ref_serve.serve(ref_cfg, prompts, max_new=6, params=ref_params)
    got, stats = port_serve.serve(cfg, prompts, max_new=6, params=params, device="cpu")
    assert got.shape == (3, 6) and stats["decode_steps"] == 5
    np.testing.assert_array_equal(got, np.asarray(want))


def test_train_step_with_prefix_matches_reference():
    """``make_train_step`` passes the batch's prefix embeddings to the
    loss: paligemma's loss and gradient norm at 1e-5 of the reference's
    step on the same parameters and batch."""
    from repro.optim import adamw_init as ref_adamw_init

    from repro_torch.optim import adamw_init

    ref_cfg, cfg = _cfgs("paligemma-3b")
    ref_params, params = _params(ref_cfg, cfg, seed=5)
    batch = _batch(cfg, seed=5)
    _, _, want = jax.jit(ref_steps.make_train_step(ref_cfg))(
        ref_params, ref_adamw_init(ref_params), {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, got = steps.make_train_step(cfg)(
        params, adamw_init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        _close(got[key], want[key], rtol=1e-5, atol=0, what=key)


def test_train_cli_feeds_prefix_embeddings(capsys):
    """``launch.train`` on reduced paligemma: the step-seeded prefix
    batch goes through two finite steps."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import train

    _, cfg = _cfgs("paligemma-3b")
    out = train(cfg, ShapeConfig("t", "train", 16, 2), steps_total=2, log_every=1,
                device="cpu")
    assert len(out["steps"]) == 2
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in out["steps"])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_engine_matches_reference_engine(arch):
    """The continuous-batching engine, 2 slots and 3 requests (exact
    buckets; hymba's prompts past its window), token for token against
    the reference's engine on the same weights."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=7)
    rng = np.random.default_rng(7)
    lens, max_new = (18, 9, 21), (5, 7, 4)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    ref_eng = RefServingEngine(ref_cfg, batch=2, max_seq=32, block=8, params=ref_params)
    decode = ref_eng._decode  # block on the step, as tests/test_torch_serving.py does
    ref_eng._decode = lambda *a: jax.block_until_ready(decode(*a))
    eng = ServingEngine(cfg, batch=2, max_seq=32, block=8, params=params, device="cpu")
    for p, n in zip(prompts, max_new):
        assert ref_eng.submit(p, n) == eng.submit(p, n)
    want, ref_m = ref_eng.run()
    got, m = eng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"rid {rid}")
    assert (m.prefills, m.decode_steps) == (ref_m.prefills, ref_m.decode_steps)
    assert sorted({e[2] for e in eng.registry._entries}) == sorted(set(lens) | {32})


def test_serve_cli_runs_the_zoo_on_cpu(capsys):
    for arch in ARCHS:
        port_serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "10",
                         "--max-new", "3", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "generations" in out and "'device': 'cpu'" in out, arch


def test_from_reference_params_checks_every_leaf():
    ref_cfg, cfg = _cfgs("hymba-1.5b")
    tree_np = jax.tree.map(np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    tree_np["layers"][0]["ssm"]["a_log"] = tree_np["layers"][0]["ssm"]["a_log"][..., :1]
    with pytest.raises(ValueError, match="leaf"):
        tf.from_reference_params(cfg, tree_np, device="cpu")
    del tree_np["layers"][0]["ssm"]
    with pytest.raises(ValueError, match="tree"):
        tf.from_reference_params(cfg, tree_np, device="cpu")


def test_unknown_block_raises():
    _, cfg = _cfgs("hymba-1.5b")
    with pytest.raises(ValueError, match="unknown block 'rwkv'"):
        tf.init_params(dataclasses.replace(cfg, block_pattern=("rwkv",)), device="cpu")
