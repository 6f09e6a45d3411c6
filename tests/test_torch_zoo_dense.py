"""The dense zoo configs no other port test holds against the reference, on
the CPU: minicpm-2b (tied embeddings, 36 heads of 64), musicgen-large
(non-gated GELU FFN), nemotron-4-15b (non-gated squared-ReLU FFN, GQA 6:1),
yi-9b (GQA 8:1) and qwen1.5-110b (GQA 8:1, q/k/v biases).  mixtral-8x7b is
held in ``tests/test_torch_moe.py``.

Each config is the reference's ``reduced()`` (and the port's), then the
same ``dataclasses.replace`` in both packages so that the head layout keeps
its group ratio, which ``reduced()`` caps at 4:4 (nemotron 12:2, yi and
qwen1.5 8:1, minicpm and musicgen 4:4); ``tie_embeddings``, ``qkv_bias``
and ``act`` are kept as they are.  The reference's seeded parameters go
over with ``tf.from_reference_params``; inputs come from seeded numpy.
Tolerances, each stated where it is used:

* ``forward`` logits and caches: rtol 1e-4 / atol 1e-5 (float32 sums in
  another order);
* ``loss_fn``: rtol 1e-5; every gradient leaf: 1e-4 x its largest |g|
  (minicpm's tied embedding sums its gradient over both uses);
* the port's teacher-forced decode against its own ``forward``: 1e-4 /
  1e-5 (the reference's own yi-9b check holds its pair at 2e-2);
* generations of ``serve()``: token for token.
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
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

# (query heads, kv heads) of each reduced config: its full config's ratio
HEADS = {"minicpm-2b": (4, 4), "musicgen-large": (4, 4), "nemotron-4-15b": (12, 2),
         "yi-9b": (8, 1), "qwen1.5-110b": (8, 1)}
ARCHS = tuple(HEADS)
RTOL, ATOL = 1e-4, 1e-5


def _cfgs(arch):
    hq, hkv = HEADS[arch]
    return tuple(dataclasses.replace(red(get(arch)), n_heads=hq, n_kv_heads=hkv)
                 for red, get in ((ref_reduced, ref_get_config), (reduced, get_config)))


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, tf.from_reference_params(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_configs_keep_their_layouts(arch):
    """The group ratio of the full config survives the reduction (nemotron
    6:1, yi and qwen1.5 8:1), and so do the traits the config exists for."""
    full = get_config(arch)
    ref_cfg, cfg = _cfgs(arch)
    assert cfg.n_heads // cfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert (ref_cfg.n_heads, ref_cfg.n_kv_heads) == (cfg.n_heads, cfg.n_kv_heads)
    for field in ("tie_embeddings", "qkv_bias", "act", "gated_ffn"):
        assert getattr(cfg, field) == getattr(full, field) == getattr(ref_cfg, field), field
    assert {"nemotron-4-15b": 6, "yi-9b": 8, "qwen1.5-110b": 8}.get(
        arch, 1) == cfg.n_heads // cfg.n_kv_heads


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    """Full logits and the collected caches, b=2, s=24."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg)
    toks = _tokens(cfg, 2, 24)
    want, want_caches, _ = ref_tf.forward(ref_params, jnp.asarray(toks), ref_cfg,
                                          collect_cache=True, remat=False)
    with torch.inference_mode():
        got, caches, _ = tf.forward(params, torch.from_numpy(toks), cfg, collect_cache=True)
    assert got.shape == want.shape == (2, 24, cfg.vocab_padded)
    _close(got, want, what="logits")
    got_leaves, want_leaves = tree.leaves(caches), jax.tree.leaves(want_caches)
    assert [tuple(g.shape) for g in got_leaves] == [w.shape for w in want_leaves]
    for g, w in zip(got_leaves, want_leaves):
        _close(g, w, what="caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` and every gradient leaf against ``jax.grad``, all finite."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=3)
    toks = _tokens(cfg, 2, 24, seed=3)
    batch = {"tokens": toks, "labels": toks}
    (want, _), want_g = jax.value_and_grad(ref_tf.loss_fn, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_equals_forward(arch):
    """Decode from empty caches, one token at a time, reproduces the port's
    own full forward at every position."""
    _, cfg = _cfgs(arch)
    params = tf.init_params(cfg, seed=1, device="cpu")
    T = 12
    toks = torch.from_numpy(_tokens(cfg, 2, T, seed=5))
    with torch.inference_mode():
        full, _, _ = tf.forward(params, toks, cfg)
        caches = tf.init_caches(cfg, 2, T, device="cpu")
        outs = [tf.decode_step(params, toks[:, t:t + 1], caches, t, cfg)[0][:, 0]
                for t in range(T)]
    _close(torch.stack(outs, dim=1), full)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generations_equal_reference(arch):
    """``serve()`` of three prompts of 20 tokens, 6 new, token for token."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    prompts = _tokens(cfg, 3, 20, seed=2)
    want, _ = ref_serve.serve(ref_cfg, prompts, max_new=6, params=ref_params)
    got, stats = port_serve.serve(cfg, prompts, max_new=6, params=params, device="cpu")
    assert got.shape == (3, 6) and stats["decode_steps"] == 5
    np.testing.assert_array_equal(got, np.asarray(want))


def test_tied_embeddings_take_the_reference_tree_without_a_head():
    """minicpm's reference tree has no ``head`` leaf: ``from_reference_params``
    takes it as it is, the logits are the embedding's transpose applied to
    the final hidden state, and a tree given a ``head`` raises."""
    ref_cfg, cfg = _cfgs("minicpm-2b")
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    tree_np = jax.tree.map(np.asarray, ref_params)
    assert "head" not in tree_np and "head" not in tf.param_labels(cfg)
    params = tf.from_reference_params(cfg, tree_np, device="cpu")
    assert "head" not in params
    assert torch.equal(params["embed"], torch.from_numpy(np.array(tree_np["embed"])))
    with pytest.raises(ValueError, match="tree"):
        tf.from_reference_params(cfg, dict(tree_np, head=tree_np["embed"].T), device="cpu")
    # the same weights with the head written out untied give the same logits
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    toks = torch.from_numpy(_tokens(cfg, 2, 10, seed=4))
    with torch.inference_mode():
        tied, _, _ = tf.forward(params, toks, cfg)
        loose, _, _ = tf.forward(dict(params, head=params["embed"].T.contiguous()), toks,
                                 untied)
    _close(tied, loose, rtol=1e-6, atol=1e-6)


def test_serve_cli_runs_the_dense_zoo_on_cpu(capsys):
    for arch in ARCHS:
        port_serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "10",
                         "--max-new", "3", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "generations" in out and "'device': 'cpu'" in out, arch
