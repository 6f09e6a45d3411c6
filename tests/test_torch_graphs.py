"""The compiled decode step (``launch.steps.GraphedStep``) and positions as
device tensors, on the CPU, against the reference.

The reference jits its decode step with ``pos`` a traced scalar and the
caches donated; the port captures the step once as a CUDA graph on a card
and replays it, which needs the position as a 0-d tensor on the device
and the step's inputs and outputs in fixed buffers.  On the CPU nothing is
captured, but the fixed-buffer plumbing is the card's (copy in, the same
output buffers every step), so these tests catch what a replay would
alias.  Reduced configs in float32, the reference's seeded parameters
carried over with ``tf.from_reference_params``, inputs from seeded numpy:

* ``transformer.decode_step`` with a tensor ``pos`` is bit-equal to the
  int path (logits and every cache leaf), and against the reference's
  ``decode_step`` with ``jnp.int32(pos)`` within rtol 1e-4 / atol 1e-5 (the
  port's other float32 tests': sums in another order), for llama,
  qwen2-moe, hymba (decoding across its window, so the ring wraps),
  xlstm and paligemma;
* ``serve()`` and the engine through the fixed buffers: generations equal
  to a loop of eager steps and to the reference's, token for token, the
  step logits bit-equal to the eager loop's;
* a token kept without a clone would be overwritten by the next step: the
  step log's and ``decode_loop``'s tokens are clones, and the columns of
  two slots differ where their tokens do;
* the launch counters of a replayed step: the capture's counts taken back
  and added once a replay (the capture faked on the CPU);
* asking for a graph on the CPU or on a mesh of more than one rank raises.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.kernels import moe_gmm, ops  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCHS = ("llama-7b", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m", "paligemma-3b")
RTOL, ATOL = 1e-4, 1e-5


def _cfgs(arch):
    return ref_reduced(ref_get_config(arch)), reduced(get_config(arch))


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
# positions as device tensors
# ---------------------------------------------------------------------------


def test_as_position_is_a_0d_int64_tensor_on_the_device():
    for pos in (7, np.int64(7), torch.tensor(7, dtype=torch.int32),
                torch.tensor([7]), torch.tensor(7)):
        p = attn.as_position(pos, torch.device("cpu"))
        assert p.shape == () and p.dtype == torch.long and int(p) == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_tensor_pos_equals_int_pos_and_reference(arch):
    """Prompt 14, eight teacher-forced decode steps at positions 14..21:
    hymba's window is 16 in the reduced config, so its ring wraps during
    the decode.  The tensor-``pos`` step writes the
    caches bit-equal to the int step's and gives its logits bit for bit;
    both packages are fed the reference's greedy tokens."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=3)
    b, s, n = 2, 14, 8
    prompts = _tokens(cfg, b, s, seed=4)
    kv_len = ref_cfg.kv_len(ref_serve.ShapeConfig("x", "decode", s + n + 1, b))
    if cfg.window:
        assert kv_len == cfg.window < s + n  # the ring wraps
    ref_logits, ref_caches = ref_steps.make_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(prompts)})
    ref_caches = ref_serve.prepare_decode_caches(ref_cfg, ref_caches, s, kv_len)
    with torch.inference_mode():
        _, caches = steps.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(prompts)})
        by_tensor = port_serve.prepare_decode_caches(cfg, caches, s, kv_len)
        by_int = tree.map(torch.clone, by_tensor)
    ref_decode = jax.jit(ref_steps.make_serve_step(ref_cfg))
    tok = np.asarray(jnp.argmax(ref_logits[:, -1], axis=-1))[:, None].astype(np.int32)
    for i in range(n):
        ref_logits, ref_caches = ref_decode(ref_params, jnp.asarray(tok), ref_caches,
                                            jnp.int32(s + i))
        with torch.inference_mode():
            t = torch.from_numpy(tok)
            got, _ = tf.decode_step(params, t, by_tensor, torch.tensor(s + i), cfg)
            want, _ = tf.decode_step(params, t, by_int, s + i, cfg)
        assert torch.equal(got, want), f"step {i}"
        np.testing.assert_allclose(_np(got), _np(ref_logits), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{arch} decode step {i}")
        tok = np.asarray(jnp.argmax(ref_logits[:, -1], axis=-1))[:, None].astype(np.int32)
    for a, c in zip(tree.leaves(by_tensor), tree.leaves(by_int)):
        assert torch.equal(a, c)
    for a, w in zip(tree.leaves(by_tensor), jax.tree.leaves(ref_caches)):
        np.testing.assert_allclose(_np(a), _np(w), rtol=RTOL, atol=ATOL)


def test_attention_decode_writes_the_slot_a_tensor_pos_names():
    """The ring write of a windowed arch at a position past the window:
    only row ``pos % W`` of the cache changes, to this step's K/V."""
    cfg = dataclasses.replace(reduced(get_config("llama-7b")), window=8)
    p = tf.init_params(cfg, seed=0, device="cpu")["layers"][0]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32))
    cache = attn.init_kv_cache(cfg, 2, 8, torch.float32)
    cache.k.normal_(generator=torch.Generator().manual_seed(1))
    before = cache.k.clone()
    with torch.inference_mode():
        attn.attention_decode(p, x, cache, torch.tensor(13), cfg)
    changed = (cache.k != before).flatten(2).any(-1).any(0)
    assert changed.tolist() == [i == 13 % 8 for i in range(8)]


# ---------------------------------------------------------------------------
# serve() and the engine through the fixed buffers
# ---------------------------------------------------------------------------


def logit_tap(decode, logs: torch.Tensor, prompt_len: int):
    """``decode`` that also writes each step's last-position logits into
    row ``pos - prompt_len`` of ``logs`` (steps, b, v) float32, on the
    device and indexed by the position tensor: a replayed graph writes
    every step's row, as the eager step does."""
    def tapped(params, tokens, caches, pos):
        logits, caches = decode(params, tokens, caches, pos)
        logs.index_copy_(0, (pos - prompt_len).view(1), logits[:, -1].float()[None])
        return logits, caches

    return tapped


def _eager_loop(cfg, params, prompts, max_new, kv_len):
    """Prefill, then ``max_new - 1`` calls of the serve step, int
    positions, no fixed buffers: the tokens and every step's logits."""
    s = prompts.shape[1]
    with torch.inference_mode():
        logits, caches = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(prompts)})
        caches = port_serve.prepare_decode_caches(cfg, caches, s, kv_len)
        decode = steps.make_serve_step(cfg)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        toks, logs = [tok], []
        for i in range(max_new - 1):
            logits, caches = decode(params, tok, caches, s + i)
            logs.append(logits[:, -1].float())
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            toks.append(tok)
    return torch.cat(toks, 1).numpy(), logs


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_fixed_buffers_equal_eager_steps_and_reference(arch):
    """``decode_loop`` through its ``GraphedStep`` (fixed token and position
    buffers, the same output buffers every step): the tokens and every
    step's logits bit-equal to a loop of eager steps, the generations of
    ``serve()`` those of the reference's ``serve``.  Every token column is
    a clone: the columns differ where the tokens do."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    prompts = _tokens(cfg, 3, 12, seed=2)
    max_new = 9
    kv_len = cfg.kv_len(port_serve.ShapeConfig("serve", "decode", 12 + max_new, 3))
    want, want_logs = _eager_loop(cfg, params, prompts, max_new, kv_len)
    with torch.inference_mode():
        logits, caches = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(prompts)})
        caches = port_serve.prepare_decode_caches(cfg, caches, 12, kv_len)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logs = torch.full((max_new - 1, 3, logits.shape[-1]), float("nan"))
        got, _, n = port_serve.decode_loop(
            logit_tap(steps.make_serve_step(cfg), logs, 12), params, caches, tok, 12,
            max_new)
    assert n == max_new - 1
    np.testing.assert_array_equal(got, want)
    for g, w in zip(logs, want_logs):
        assert torch.equal(g, w)
    assert len({tuple(c) for c in got.T}) > 1  # not one buffer read max_new times
    gen, stats = port_serve.serve(cfg, prompts, max_new=max_new, params=params,
                                  device="cpu")
    assert stats["graph"] is False and stats["decode_steps"] == max_new - 1
    np.testing.assert_array_equal(gen, want)
    ref_gen, _ = ref_serve.serve(ref_cfg, prompts, max_new=max_new, params=ref_params)
    np.testing.assert_array_equal(gen, np.asarray(ref_gen))
    eager, _ = port_serve.serve(cfg, prompts, max_new=max_new, params=params,
                                device="cpu", graph=False)
    np.testing.assert_array_equal(eager, gen)


ENGINE_ARCHS = ("llama-7b", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m")


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_fixed_buffers_equal_reference_engine(arch):
    """The engine, 2 slots and 3 requests (hymba's prompts past its window),
    its decode step through the fixed buffers: token for token the
    reference engine's (which blocks on its step, as
    tests/test_torch_serving.py runs it) and the eager engine's
    (``graph=False``)."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=7)
    rng = np.random.default_rng(7)
    lens, max_new = (18, 9, 21), (5, 7, 4)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    ref_eng = RefServingEngine(ref_cfg, batch=2, max_seq=32, block=8, params=ref_params)
    decode = ref_eng._decode
    ref_eng._decode = lambda *a: jax.block_until_ready(decode(*a))
    got = []
    for graph in (None, False):
        eng = ServingEngine(cfg, batch=2, max_seq=32, block=8, params=params,
                            device="cpu", graph=graph)
        assert eng.graph is False
        for p, n in zip(prompts, max_new):
            eng.submit(p, n)
        got.append(eng.run()[0])
    for p, n in zip(prompts, max_new):
        ref_eng.submit(p, n)
    want, _ = ref_eng.run()
    for rid in want:
        np.testing.assert_array_equal(got[0][rid], np.asarray(want[rid]), err_msg=f"rid {rid}")
        np.testing.assert_array_equal(got[1][rid], got[0][rid])


def test_engine_step_log_holds_clones_of_the_fixed_output():
    """Two slots decoding different prompts, step by step: every logged
    token tensor is its own clone, not the step's fixed output buffer,
    which the next step overwrites; the slots' columns differ where their
    tokens do, and each equals that request's sequential ``serve()``."""
    cfg = reduced(get_config("llama-7b"))
    params = tf.init_params(cfg, seed=5, device="cpu")
    prompts = list(_tokens(cfg, 2, 10, seed=5))
    eng = ServingEngine(cfg, batch=2, max_seq=32, block=8, params=params, device="cpu")
    for p in prompts:
        eng.submit(p, 8)
    with torch.inference_mode():
        eng._admit_phase()
        for _ in range(4):
            eng._decode_phase()
    fixed = eng._step.outputs[0]
    ptrs = {t.data_ptr() for t in eng._step_log}
    assert len(ptrs) == 4 and fixed.data_ptr() not in ptrs
    assert torch.equal(eng._step_log[-1], fixed)
    mat = torch.cat(eng._step_log, 1).numpy()
    for slot, p in enumerate(prompts):
        gen, _ = port_serve.serve(cfg, p[None], max_new=5, params=params, kv_len=eng.seq,
                                  device="cpu")
        np.testing.assert_array_equal(mat[slot], gen[0, 1:])
    assert (mat[0] != mat[1]).any()
    assert len({tuple(c) for c in mat.T}) > 1


def test_engine_with_its_compiled_step_is_freed_when_dropped():
    """The compiled step holds the engine's ``_decode`` and parameters,
    not the engine: an engine that has decoded is freed (its pools and
    graph with it) as soon as the last reference goes, without waiting for
    the cycle collector."""
    import gc
    import weakref

    cfg = reduced(get_config("llama-7b"))
    params = tf.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, batch=1, max_seq=16, block=8, params=params, device="cpu")
    eng.submit(_tokens(cfg, 1, 5)[0], 3)
    eng.run()
    assert eng._step is not None
    gone = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the counters of a replayed step
# ---------------------------------------------------------------------------


def _fake_launch(design="wgmma"):
    """What a kernel wrapper does to its counters when it launches."""
    moe_gmm.gmm.launches += 1
    moe_gmm.gmm.designs[design] += 1


def test_counter_snapshot_arithmetic():
    ops.reset_launch_counts()
    _fake_launch()
    snap = ops.snapshot_counts()
    for _ in range(3):
        _fake_launch()
    _fake_launch("ffma")
    delta = ops.counts_since(snap)
    assert delta["gmm"] == (4, {"wgmma": 3, "ffma": 1, "template": 0})
    assert delta["flash_attention"] == (0, {"wgmma": 0, "ffma": 0, "template": 0})
    ops.restore_counts(snap)
    assert ops.launch_counts()["gmm"] == 1
    ops.add_counts(delta)
    ops.add_counts(delta)
    assert ops.launch_counts()["gmm"] == 9
    assert ops.design_counts()["gmm"] == {"wgmma": 7, "ffma": 2, "template": 0}
    ops.reset_launch_counts()


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` stand-in: capture records the calls the
    body makes of ``_fake_launch``'s kernel, and a replay does the device
    work (here: the step's arithmetic, set by ``on_end``) without running
    the Python again."""

    captures = 0
    on_end = None

    def __init__(self):
        self.work = None

    def capture_begin(self, pool=None):
        _FakeGraph.captures += 1

    def capture_end(self):
        _FakeGraph.on_end(self)

    def replay(self):
        self.work()


def test_graphed_step_counts_the_warm_up_and_each_replay(monkeypatch):
    """A step that launches 3 gmm kernels: the warm-up call counts 3, the
    capture counts nothing, and each replay adds the 3 its capture made;
    the outputs are the same fixed buffers every call."""
    state = {"x": torch.zeros(2)}
    runs = []

    def fn(state, step_in):
        for _ in range(3):
            _fake_launch()
        runs.append(int(step_in))
        return step_in * 2

    def on_end(g):
        g.work = lambda: run.outputs[0].copy_(run.inputs["step_in"] * 2)

    monkeypatch.setattr(_FakeGraph, "on_end", staticmethod(on_end))
    monkeypatch.setattr(steps, "_SIDE", {})
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    fake_cuda = types.SimpleNamespace(
        CUDAGraph=_FakeGraph, Stream=lambda device: stream,
        current_stream=lambda device: stream, stream=lambda s: contextlib.nullcontext())
    monkeypatch.setattr(steps.torch, "cuda", fake_cuda)
    ops.reset_launch_counts()
    run = steps.GraphedStep(fn, state, {"step_in": torch.tensor(5)}, graph=False)
    run.graphed = True  # as on a card (the capture is faked)
    _FakeGraph.captures = 0
    # the warm-up's outputs are read on the main stream: record_stream on a CPU tensor
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    first = run()
    assert ops.launch_counts()["gmm"] == 3 and run.replays == 0 and runs == [5]
    run.inputs["step_in"].fill_(6)
    second = run()
    assert _FakeGraph.captures == 1 and runs == [5, 6]  # the capture ran the Python once
    assert ops.launch_counts()["gmm"] == 6 and run.replays == 1
    for i in range(3):
        run.inputs["step_in"].fill_(7 + i)
        out = run()
        assert out is first is second and int(out[0]) == 2 * (7 + i)
    assert runs == [5, 6] and run.replays == 4
    assert ops.launch_counts()["gmm"] == 3 * 5
    assert ops.design_counts()["gmm"]["wgmma"] == 15
    ops.reset_launch_counts()


def test_graphed_step_failed_capture_raises_and_keeps_no_graph(monkeypatch):
    """A step whose Python fails under capture (as a host read does on a
    card): the call raises, the capture is ended, no graph is kept, the
    counters lose the capture's launches, and the step does not run
    eagerly instead."""
    ended = []

    def on_end(g):
        ended.append(g)

    monkeypatch.setattr(_FakeGraph, "on_end", staticmethod(on_end))
    monkeypatch.setattr(steps, "_SIDE", {})
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(steps.torch, "cuda", types.SimpleNamespace(
        CUDAGraph=_FakeGraph, Stream=lambda device: stream,
        current_stream=lambda device: stream, stream=lambda s: contextlib.nullcontext()))
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    calls = []

    def fn(state, step_in):
        _fake_launch()
        calls.append(int(step_in))
        if len(calls) > 1:
            raise RuntimeError("operation not permitted when stream is capturing")
        return step_in + 1

    ops.reset_launch_counts()
    run = steps.GraphedStep(fn, None, {"step_in": torch.tensor(1)}, graph=False)
    run.graphed = True  # as on a card (the capture is faked)
    run()
    with pytest.raises(RuntimeError, match="capturing"):
        run()
    assert len(ended) == 1 and run._graph is None and run.replays == 0
    assert calls == [1, 1] and ops.launch_counts()["gmm"] == 1
    ops.reset_launch_counts()


def test_graphed_step_eager_outputs_are_fixed_buffers():
    """Without a graph every call copies into the same output buffers: a
    caller that keeps one without a clone sees the next step's value."""
    run = steps.GraphedStep(lambda st, a: (a + 1, a * 3), None,
                            {"a": torch.tensor([1, 2])})
    assert run.graphed is False
    out = run()
    kept = out[0]
    run.inputs["a"].copy_(torch.tensor([10, 20]))
    again = run()
    assert again[0] is kept and kept.tolist() == [11, 21]
    assert again[1].tolist() == [30, 60]


# ---------------------------------------------------------------------------
# where a graph is captured
# ---------------------------------------------------------------------------


def test_graph_rule_and_explicit_requests_that_raise():
    two = types.SimpleNamespace(world_size=2, device=torch.device("cuda"))
    one = types.SimpleNamespace(world_size=1, device=torch.device("cuda"))
    assert steps.use_graph(None, "cuda") is True
    assert steps.use_graph(None, "cuda", one) is True
    assert steps.use_graph(None, "cuda", two) is False
    assert steps.use_graph(None, "cpu") is False
    assert steps.use_graph(False, "cuda") is False
    assert steps.use_graph(True, "cuda") is True
    with pytest.raises(ValueError, match="cpu"):
        steps.use_graph(True, "cpu")
    with pytest.raises(ValueError, match="mesh"):
        steps.use_graph(True, "cuda", two)
    with pytest.raises(ValueError, match="cpu"):
        steps.GraphedStep(lambda st, a: a, None, {"a": torch.zeros(1)}, graph=True)
    cfg = reduced(get_config("llama-7b"))
    params = tf.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="cpu"):
        port_serve.serve(cfg, _tokens(cfg, 1, 4), max_new=2, params=params, device="cpu",
                         graph=True)
    with pytest.raises(ValueError, match="cpu"):
        ServingEngine(cfg, batch=1, max_seq=16, block=8, params=params, device="cpu",
                      graph=True)
