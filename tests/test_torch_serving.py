"""The port's serving tier against the reference's, on the CPU.

Reduced configs; the reference's seeded parameters carried over with
``tf.from_reference_params``; inputs from seeded numpy; ``device="cpu"``,
where the port runs the plain versions of its kernels.  Float32 numerics
agree at rtol 1e-4 / atol 1e-5 (the sums run in another order, as in
``tests/test_torch_serve.py``); the admission scatter is a copy, so it is
held bit for bit; generations are held token for token:

* block allocator and bucket policy (the reference's own tests, mirrored);
* the bucket registry: warm after first touch, plan-cache hits across
  registries, and the reference's canonical keys and plan JSON;
* ``attention_decode_paged`` and ``decode_step_paged`` (slots at different
  positions, one idle slot on the scratch block; logits and live pool
  rows), ``forward(logit_index=)``, and admission;
* the engine against the reference's engine (llama mha / gqa / window and
  reduced qwen2-moe), against the port's sequential ``serve()``, and with
  one slot reused by three requests (a token buffer written in place would
  rewrite the token the step log holds for the request evicted from it);
* its errors, and the ``--continuous`` command line.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.plancache import PlanCache as RefPlanCache  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import BucketRegistry as RefBucketRegistry  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402
from repro.serving.paged_kv import make_admit_fn as ref_make_admit_fn  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.plancache import PlanCache  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import (BlockAllocator, BucketRegistry,  # noqa: E402
                                 ServingEngine, bucket_len, make_admit_fn,
                                 pad_free)

LLAMA = {"mha": {}, "gqa": {"n_kv_heads": 2}, "window": {"window": 8}}
CONFIGS = {name: ("llama-7b", kw) for name, kw in LLAMA.items()}
CONFIGS["qwen2-moe"] = ("qwen2-moe-a2.7b", {})
RTOL, ATOL = 1e-4, 1e-5


def _cfgs(name):
    arch, kw = CONFIGS[name]
    kw = dict(kw, dtype="float32")
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_params, tf.from_reference_params(cfg, tree, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# block allocator and bucket policy
# ---------------------------------------------------------------------------


def test_block_allocator_reserves_scratch_and_recycles():
    al = BlockAllocator(n_blocks=5, block=8)              # blocks 1..4 free
    assert al.n_free == 4
    a = al.alloc(3)
    assert a == [1, 2, 3] and 0 not in a
    assert al.alloc(2) is None                            # all-or-nothing
    assert al.n_free == 1                                 # failed alloc kept
    al.release(a)
    assert al.n_free == 4
    with pytest.raises(ValueError):
        al.release([1])                                   # double free
    with pytest.raises(ValueError):
        al.release([0])                                   # scratch is not
    assert al.blocks_for(17) == 3                         #   allocatable
    with pytest.raises(ValueError):
        BlockAllocator(n_blocks=1, block=8)
    assert 0 not in BlockAllocator(n_blocks=9, block=4).alloc(8)


def test_bucket_policy_pow2_only_when_pad_free():
    llama = reduced(get_config("llama-7b"))
    xlstm = reduced(get_config("xlstm-125m"))
    moe = reduced(get_config("mixtral-8x7b"))
    assert pad_free(llama) and not pad_free(xlstm) and not pad_free(moe)
    assert bucket_len(llama, 13) == 16                    # pow2 rounding
    assert bucket_len(llama, 16) == 16
    assert bucket_len(llama, 3) == 8                      # min bucket
    assert bucket_len(xlstm, 13) == 13                    # recurrent: exact
    assert bucket_len(moe, 13) == 13                      # capacity: exact
    assert bucket_len(llama, 13, mode="exact") == 13
    assert bucket_len(xlstm, 13, mode="pow2") == 16       # explicit override
    with pytest.raises(ValueError):
        bucket_len(llama, 13, mode="round")


# ---------------------------------------------------------------------------
# the bucket registry
# ---------------------------------------------------------------------------


def test_bucket_registry_warm_after_first_touch():
    cfg = reduced(get_config("llama-7b"))
    pc = PlanCache()
    reg = BucketRegistry(cfg, plan_cache=pc, device="cpu")
    e1 = reg.prefill(13)
    e2 = reg.prefill(14)                                  # same pow2 bucket
    assert e1 is e2 and e1.hits == 1
    assert reg.stats.compiles == 1 and reg.stats.lookups == 2
    assert e1.key[2] == 16 and e1.canonical_key and not e1.cache_hit
    # a second registry on the same plan cache skips the DP (warm hit)
    reg2 = BucketRegistry(cfg, plan_cache=pc, device="cpu")
    e3 = reg2.prefill(13)
    assert reg2.stats.plan_cache_hits == 1 and e3.cache_hit
    assert e3.canonical_key == e1.canonical_key
    with pytest.raises(ValueError):
        reg.decode(20, 2, 8)                              # not whole blocks


def test_bucket_registry_keys_and_paged_plan_equal_reference(tmp_path):
    ref_cfg, cfg = _cfgs("gqa")
    ref_reg = RefBucketRegistry(ref_cfg, make_host_mesh(),
                                plan_cache=RefPlanCache())
    store = str(tmp_path / "plans.json")
    reg = BucketRegistry(cfg, plan_cache=store, device="cpu")
    assert (reg.prefill(13).canonical_key
            == ref_reg.prefill(13).canonical_key)
    ref_dec, dec = ref_reg.decode(24, 2, 8), reg.decode(24, 2, 8)
    assert dec.key == ref_dec.key == (cfg.name, "decode", 24, 2, 8)
    assert dec.canonical_key == ref_dec.canonical_key
    assert dec.compiled.plan.to_json() == ref_dec.compiled.plan.to_json()
    # the store the port wrote: a registry in a new process plans from it
    again = BucketRegistry(cfg, plan_cache=store, device="cpu")
    assert again.decode(24, 2, 8).cache_hit
    # the explicit-collective executor on the one-rank mesh plans the same
    sm = BucketRegistry(cfg, plan_cache=store, executor="shard_map", device="cpu")
    ent = sm.decode(24, 2, 8)
    assert ent.cache_hit and ent.compiled.collectives is not None
    assert ent.compiled.plan.to_json() == ref_dec.compiled.plan.to_json()


def test_bucket_registry_raises_for_what_is_not_ported():
    """``analyze()`` is ported (the static verifier): every live bucket
    comes back as a clean report; a mesh of two ranks still raises (ROADMAP
    Queue 1 item 4)."""
    cfg = reduced(get_config("llama-7b"))
    reg = BucketRegistry(cfg, device="cpu")
    assert reg.analyze() == {}
    reg.prefill(13)
    reports = reg.analyze()
    assert list(reports) == [(cfg.name, "prefill", 16, 1, 0)]
    assert not reports[(cfg.name, "prefill", 16, 1, 0)].findings
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        BucketRegistry(cfg, {"data": 2, "model": 1}, device="cpu")


@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_admission_sets_the_slot_state_rows(arch):
    """Admission of a recurrent arch, which raised until the recurrent
    slice: the request's prefill states land in its slot's rows of every
    state leaf as the reference's admission puts them (the two packages'
    prefills agree at this file's float32 tolerance), the other slots'
    rows stay as they were, and hymba's KV goes into the pool under the
    table row."""
    ref_cfg, cfg = (ref_reduced(ref_get_config(arch)), reduced(get_config(arch)))
    ref_params, params = _params(ref_cfg, cfg, seed=3)
    prompt = _prompts(cfg, [11], seed=3)[0]
    ref_logits, ref_pre = ref_tf.forward(ref_params, jnp.asarray(prompt[None]), ref_cfg,
                                         collect_cache=True, remat=False)[:2]
    with torch.inference_mode():
        _, pre, _ = tf.forward(params, torch.from_numpy(prompt[None]), cfg,
                               collect_cache=True)
        caches = tf.init_paged_caches(cfg, 3, 6, 4, device="cpu")
        for leaf in tree.leaves(caches):
            leaf.fill_(0.5)
        blocks = torch.tensor([2, 3, 4], dtype=torch.int32)
        out, _ = make_admit_fn(cfg)(caches, pre, blocks, 1, torch.tensor([7], dtype=torch.int32),
                                    torch.zeros((3, 1), dtype=torch.int32))
    ref_caches = ref_tf.init_paged_caches(ref_cfg, 3, 6, 4)
    ref_caches = jax.tree.map(lambda t: jnp.full_like(t, 0.5), ref_caches)
    ref_out, _ = ref_make_admit_fn(ref_cfg)(ref_caches, ref_pre, jnp.asarray([2, 3, 4]),
                                            1, jnp.asarray([7], jnp.int32),
                                            jnp.zeros((3, 1), jnp.int32))
    got_leaves, want_leaves = tree.leaves(out), jax.tree.leaves(ref_out)
    assert len(got_leaves) == len(want_leaves)
    n_state = 0
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)
        if g.shape[1] == 3:  # a per-slot state leaf (units, slots, ...)
            n_state += 1
            assert (g[:, [0, 2]] == 0.5).all()
            assert not (g[:, 1] == 0.5).all()
    assert n_state == {"xlstm-125m": 7, "hymba-1.5b": 2}[arch]
    assert out is caches


# ---------------------------------------------------------------------------
# paged decode against the reference
# ---------------------------------------------------------------------------

BLK, W = 4, 3
# slot 0 at position 9 (its third block), slot 1 at 5 (a 0-padded table
# row), slot 2 idle: table row 0 and position 0, writing the scratch block
TABLES = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
POS = np.array([9, 5, 0], np.int32)


def _live_rows(pool, pos):
    """The pool rows the active slots own up to their positions."""
    out = []
    for b in range(2):
        for t in range(int(pos[b]) + 1):
            out.append(pool[..., TABLES[b, t // BLK], t % BLK, :, :])
    return np.stack(out)


@pytest.mark.parametrize("variant", sorted(LLAMA))
def test_attention_decode_paged_matches_reference(variant):
    ref_cfg, cfg = _cfgs(variant)
    ref_params, _ = _params(ref_cfg, cfg)
    p_ref = jax.tree.map(lambda a: a[0], ref_params["layers"][0]["attn"])
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    rng = np.random.default_rng(3)
    shape = (7, BLK, cfg.n_kv_heads, cfg.hd)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)

    want, ref_pool = ref_attn.attention_decode_paged(
        p_ref, jnp.asarray(x), ref_attn.PagedKVCache(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(TABLES), jnp.asarray(POS), ref_cfg)
    pool = attn.init_paged_kv_cache(cfg, 7, BLK, torch.float32, device="cpu")
    pool.k.copy_(torch.from_numpy(k0))
    pool.v.copy_(torch.from_numpy(v0))
    got, out_pool = attn.attention_decode_paged(
        p, torch.from_numpy(x), pool, torch.from_numpy(TABLES),
        torch.from_numpy(POS), cfg)
    assert out_pool is pool                               # written in place
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    for mine, theirs in ((pool.k, ref_pool.k), (pool.v, ref_pool.v)):
        np.testing.assert_allclose(_live_rows(_np(mine), POS),
                                   _live_rows(_np(theirs), POS), rtol=RTOL, atol=ATOL)
        # every block but the scratch one is the reference's
        np.testing.assert_allclose(_np(mine)[1:], _np(theirs)[1:], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", sorted(LLAMA))
def test_decode_step_paged_matches_reference(variant):
    ref_cfg, cfg = _cfgs(variant)
    ref_params, params = _params(ref_cfg, cfg)
    rng = np.random.default_rng(4)
    units = cfg.n_layers // len(cfg.block_pattern)
    shape = (units, 7, BLK, cfg.n_kv_heads, cfg.hd)
    kv = [(rng.normal(size=shape).astype(np.float32),
           rng.normal(size=shape).astype(np.float32)) for _ in cfg.block_pattern]
    ref_caches = [ref_attn.PagedKVCache(jnp.asarray(k), jnp.asarray(v)) for k, v in kv]
    caches = tf.init_paged_caches(cfg, 3, 7, BLK, device="cpu")
    for c, (k, v) in zip(caches, kv):
        c.k.copy_(torch.from_numpy(k))
        c.v.copy_(torch.from_numpy(v))
    tok = rng.integers(0, cfg.vocab, size=(3, 1)).astype(np.int32)
    pos = POS.copy()
    decode = steps.make_paged_serve_step(cfg)
    for step in range(2):                                 # two steps, slots moving on
        want, ref_caches = ref_tf.decode_step_paged(
            ref_params, jnp.asarray(tok), ref_caches, jnp.asarray(TABLES),
            jnp.asarray(pos), ref_cfg)
        with torch.inference_mode():
            got, caches = decode(params, torch.from_numpy(tok), caches,
                                 torch.from_numpy(TABLES), torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {step}")
        for c, rc in zip(caches, ref_caches):
            for mine, theirs in ((c.k, rc.k), (c.v, rc.v)):
                np.testing.assert_allclose(_live_rows(_np(mine), pos),
                                           _live_rows(_np(theirs), pos),
                                           rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(_np(mine)[:, 1:], _np(theirs)[:, 1:],
                                           rtol=RTOL, atol=ATOL)
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None].astype(np.int32)
        pos[:2] += 1


def test_init_paged_caches_shape_and_device():
    _, cfg = _cfgs("gqa")
    caches = tf.init_paged_caches(cfg, 2, 5, 8, device="cpu")
    units = cfg.n_layers // len(cfg.block_pattern)
    assert len(caches) == len(cfg.block_pattern)
    assert caches[0].k.shape == (units, 5, 8, cfg.n_kv_heads, cfg.hd)
    assert caches[0].k.device.type == "cpu" and not caches[0].k.any()


# ---------------------------------------------------------------------------
# bucketed prefill and admission
# ---------------------------------------------------------------------------


def _padded(cfg, plen=13, bucket=16, b=2):
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(b, plen)).astype(np.int32)
    padded = np.zeros((b, bucket), np.int32)
    padded[:, :plen] = toks
    return toks, padded


@pytest.mark.parametrize("variant", ["gqa", "window"])
def test_forward_logit_index_matches_reference(variant):
    ref_cfg, cfg = _cfgs(variant)
    ref_params, params = _params(ref_cfg, cfg)
    _, padded = _padded(cfg)
    want, ref_caches, _ = ref_tf.forward(ref_params, jnp.asarray(padded), ref_cfg,
                                         collect_cache=True, remat=False,
                                         logit_index=jnp.int32(12))
    with torch.inference_mode():
        got, caches = steps.make_bucket_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(padded)}, 12)
    assert got.shape == want.shape == (2, 1, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    for (k, v), (rk, rv) in zip(caches, ref_caches):
        np.testing.assert_allclose(_np(k), _np(rk), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(v), _np(rv), rtol=RTOL, atol=ATOL)


def test_bucket_padded_prefill_logit_close_to_exact_prefill():
    """Inside the port: the logit at the last real token of a bucket-padded
    prompt against the exact-length prefill.  The pad rows sit behind the
    causal mask; the (b, s) products run at another length, so the sums may
    round differently: 1e-5 of max|logit|, equal argmax, not bit for bit."""
    _, cfg = _cfgs("gqa")
    params = tf.init_params(cfg, seed=0, device="cpu")
    toks, padded = _padded(cfg)
    with torch.inference_mode():
        exact, caches_e, _ = tf.forward(params, torch.from_numpy(toks), cfg,
                                        collect_cache=True, last_logit_only=True)
        buck, caches_b, _ = tf.forward(params, torch.from_numpy(padded), cfg,
                                       collect_cache=True, logit_index=12)
    scale = float(exact.abs().max())
    np.testing.assert_allclose(_np(buck), _np(exact), rtol=0, atol=1e-5 * scale)
    assert torch.equal(exact.argmax(-1), buck.argmax(-1))
    np.testing.assert_allclose(_np(caches_b[0][0])[:, :, :13], _np(caches_e[0][0]),
                               rtol=0, atol=1e-5 * float(caches_e[0][0].abs().max()))


@pytest.mark.parametrize("s", [13, 30])                   # padded, truncated
def test_admit_pool_equals_reference_exactly(s):
    ref_cfg, cfg = _cfgs("gqa")
    rng = np.random.default_rng(6)
    units = cfg.n_layers // len(cfg.block_pattern)
    n_blocks, blk = 9, 8
    pool_shape = (units, n_blocks, blk, cfg.n_kv_heads, cfg.hd)
    k0, v0 = (rng.normal(size=pool_shape).astype(np.float32) for _ in range(2))
    pre = [(rng.normal(size=(units, 1, s, cfg.n_kv_heads, cfg.hd)).astype(np.float32),
            rng.normal(size=(units, 1, s, cfg.n_kv_heads, cfg.hd)).astype(np.float32))]
    blocks = np.array([3, 5, 0], np.int32)                # 0-padded table row
    toks = np.array([[7], [8]], np.int32)

    ref_caches, ref_toks = ref_make_admit_fn(ref_cfg)(
        [ref_attn.PagedKVCache(jnp.asarray(k0), jnp.asarray(v0))],
        [tuple(jnp.asarray(a) for a in pre[0])], jnp.asarray(blocks), jnp.int32(1),
        jnp.asarray([42], jnp.int32), jnp.asarray(toks))
    caches = [attn.PagedKVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))]
    tokens = torch.from_numpy(toks.copy())
    out, new_tokens = make_admit_fn(cfg)(
        caches, [tuple(torch.from_numpy(a) for a in pre[0])], torch.from_numpy(blocks), 1,
        torch.tensor([42], dtype=torch.int32), tokens)
    assert out[0] is caches[0]                            # pools written in place
    np.testing.assert_array_equal(out[0].k.numpy(), np.asarray(ref_caches[0].k))
    np.testing.assert_array_equal(out[0].v.numpy(), np.asarray(ref_caches[0].v))
    np.testing.assert_array_equal(new_tokens.numpy(), np.asarray(ref_toks))
    # the token buffer passed in is not written: the engine's step log holds it
    np.testing.assert_array_equal(tokens.numpy(), toks)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

LENS, MAX_NEW = (5, 9, 12), (4, 6, 3)


def _engines(name, *, batch=2, lens=LENS, max_new=MAX_NEW, seed=0):
    """The reference's engine and the port's on the same params and
    prompts; returns (ref results, ref metrics, port engine, port results,
    port metrics, prompts, port params)."""
    ref_cfg, cfg = _cfgs(name)
    ref_params, params = _params(ref_cfg, cfg, seed=seed)
    prompts = _prompts(cfg, lens, seed=seed)
    ref_eng = RefServingEngine(ref_cfg, batch=batch, max_seq=24, block=8,
                               params=ref_params)
    # The reference hands its host arrays (tables, positions) to a decode
    # step that runs asynchronously, and mutates them before the step has
    # read them, so its generations vary from run to run on the CPU; a step
    # that completes before it returns gives the generations of its own
    # sequential serve(), every run.
    decode = ref_eng._decode
    ref_eng._decode = lambda *a: jax.block_until_ready(decode(*a))
    eng = ServingEngine(cfg, batch=batch, max_seq=24, block=8, params=params,
                        device="cpu")
    for p, n in zip(prompts, max_new):
        assert ref_eng.submit(p, n) == eng.submit(p, n)
    want, ref_metrics = ref_eng.run()
    got, metrics = eng.run()
    return want, ref_metrics, eng, got, metrics, prompts, params


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_reference_engine(name):
    want, ref_m, eng, got, m, _, _ = _engines(name)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        assert got[rid].dtype == np.int32 and len(got[rid]) == MAX_NEW[rid]
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]), err_msg=f"rid {rid}")
    assert (m.prefills, m.decode_steps, m.tokens_generated) == \
        (ref_m.prefills, ref_m.decode_steps, ref_m.tokens_generated)
    assert m.prefills == 3 and m.tokens_generated == sum(MAX_NEW)
    assert m.occupancy == ref_m.occupancy and m.queue_depth == ref_m.queue_depth
    assert len(m.ttft_s) == 3 and 0 < m.summary()["mean_occupancy"] <= 1
    # everything handed back: no live slot, every block free again
    assert eng.slots == [None] * eng.batch and eng.alloc.n_free == eng.alloc.n_blocks - 1
    assert not eng.tables.any() and not eng.pos.any()


@pytest.mark.parametrize("name", sorted(LLAMA))
def test_engine_matches_sequential_serve(name):
    _, _, eng, got, _, prompts, params = _engines(name)
    for rid, (p, n) in enumerate(zip(prompts, MAX_NEW)):
        gen, _ = port_serve.serve(eng.cfg, p[None, :], max_new=n, params=params,
                                  kv_len=eng.seq, device="cpu")
        np.testing.assert_array_equal(got[rid], gen[0], err_msg=f"rid {rid}")


def test_slot_reuse_keeps_the_evicted_requests_tokens():
    """One slot, three requests: each admission lands in the slot the last
    request left, while the step log still holds that request's final token
    tensor, which is also the engine's token buffer."""
    lens, max_new = (6, 11, 8), (5, 4, 6)
    want, _, eng, got, m, prompts, params = _engines("gqa", batch=1, lens=lens,
                                                     max_new=max_new, seed=2)
    assert m.occupancy == [1.0] * m.decode_steps and m.prefills == 3
    for rid, (p, n) in enumerate(zip(prompts, max_new)):
        gen, _ = port_serve.serve(eng.cfg, p[None, :], max_new=n, params=params,
                                  kv_len=eng.seq, device="cpu")
        np.testing.assert_array_equal(got[rid], gen[0], err_msg=f"rid {rid}")
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def test_engine_max_new_one_and_eos():
    _, cfg = _cfgs("mha")
    params = tf.init_params(cfg, seed=0, device="cpu")
    p = _prompts(cfg, (7,))[0]
    eng = ServingEngine(cfg, batch=2, max_seq=24, block=8, params=params, device="cpu")
    eng.submit(p, 1)                                      # evicted at admission
    full = eng.submit(p, 6)
    res, m = eng.run()
    assert len(res[0]) == 1 and len(res[full]) == 6 and res[0][0] == res[full][0]
    # eos: the request stops at the first generated occurrence of its id
    eos = int(res[full][2])
    eng2 = ServingEngine(cfg, batch=2, max_seq=24, block=8, params=params,
                         eos_id=eos, device="cpu")
    eng2.submit(p, 6)
    res2, _ = eng2.run()
    stop = 1 + next(i for i in range(1, 6) if res[full][i] == eos)
    np.testing.assert_array_equal(res2[0], res[full][:stop])


def test_engine_rejects_oversized_request_and_detects_deadlock():
    cfg = reduced(get_config("llama-7b"))
    params = tf.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, batch=2, max_seq=16, block=8, params=params, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.zeros(20, np.int32), 8)             # > max_seq
    with pytest.raises(ValueError):
        eng.submit(np.zeros(4, np.int32), 0)

    tiny = ServingEngine(cfg, batch=1, max_seq=24, block=8, n_blocks=2,
                         params=params, device="cpu")
    tiny.submit(np.zeros(12, np.int32), 8)                # needs 3 blocks,
    with pytest.raises(RuntimeError, match="deadlock"):   # pool has 1
        tiny.run()


def test_engine_without_device_raises_where_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("llama-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, batch=1, max_seq=16, block=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BucketRegistry(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_paged_caches(cfg, 1, 3, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--arch", "llama-7b", "--reduced", "--continuous"])


def test_continuous_command_line_runs_on_the_cpu(capsys):
    port_serve.main(["--arch", "llama-7b", "--reduced", "--continuous",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("request ") == 8                     # --requests default
    assert "'prefills': 8" in out and "'tokens_generated': 128" in out
    assert "RegistryStats(compiles=" in out


@pytest.mark.parametrize("s", [256, 512])
def test_engine_prefill_shape_takes_the_wgmma_flash_design(s):
    """An engine prefill reaches the flash kernel at batch 1: q, k and v as
    transposed views of the (1, s, heads, 128) bf16 projections (float32
    in the f32 engine, which takes the ffma design).  The shape rule reads
    only shapes, strides and addresses, so it is checked here on CPU
    tensors laid out as on the card."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (torch.empty(1, s, 32, 128, dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    assert fa.design(q, k, v) == "wgmma"
    assert fa.design(q.float(), k.float(), v.float()) == "ffma"
