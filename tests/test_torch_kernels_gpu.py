"""On a card: the CUDA kernels (flash attention, the ring-attention step,
matmul, gmm) against their plain torch versions, in every design of each
(the wgmma design for bf16, the ffma design for float32 at head dim 64,
128 and 256, and the template, which the shape rule picks before launch), the reduced
serving path on
the card against the CPU (the serve loop and the continuous-batching
engine), a reduced llama program through the
explicit-collective executor on the one-card mesh, the ring on two
gloo ranks that share the card, a donated executor call's allocator
peak against the memory pass, and the compiled decode step (one CUDA
graph replayed per step) against the eager step, through ``serve()``'s
loop and the engine; the engine's compiled bucket prefills with their
admission (one graph a bucket, one shared pool) against eager, a failed
capture raising, and ``train()``'s compiled step against eager within
two eager runs' spread.

Imports torch and the port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (inside the test, so every worker collects
the same tests).  Tolerances are the reference kernel tests' own: 2e-5 in
float32, 2e-2 in bfloat16 for attention; 1e-4 and 3e-2 (atol x8) for
matmul and gmm.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

# (b, hq, hkv, sq, sk, d, causal, window, dtype)
CASES = [
    (1, 4, 2, 128, 128, 64, True, 0, "float32"),     # tests/test_kernels.py
    (2, 2, 1, 256, 256, 32, True, 64, "float32"),
    (1, 2, 2, 128, 256, 64, False, 0, "float32"),
    (1, 8, 1, 128, 128, 128, True, 0, "float32"),
    (1, 4, 4, 128, 128, 64, True, 0, "bfloat16"),
    (2, 4, 2, 64, 64, 16, True, 32, "float32"),
    (1, 2, 2, 200, 200, 64, True, 0, "float32"),     # ragged
    (2, 8, 2, 77, 77, 32, True, 0, "float32"),       # ragged, GQA 4:1
    (1, 4, 1, 50, 130, 64, True, 24, "float32"),     # window, q_offset
    (1, 2, 2, 33, 70, 16, False, 0, "float32"),
    (1, 4, 2, 100, 100, 128, True, 0, "bfloat16"),
    (1, 2, 1, 40, 90, 256, False, 0, "float32"),     # the largest head_dim
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case_id(c):
    return "b{}h{}k{}q{}s{}d{}{}w{}{}".format(c[0], c[1], c[2], c[3], c[4], c[5],
                                              "c" if c[6] else "", c[7], c[8][:2])


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cuda_kernel_matches_plain_version(case, cuda):
    b, hq, hkv, sq, sk, d, causal, window, dt = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device=cuda, dtype=getattr(torch, dt))
        for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, q_offset=sk - sq if causal else 0)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = ref.attention(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.gpu
def test_cuda_kernel_takes_transposed_views(cuda):
    """The model hands the kernel (b, s, h, d) projections as transposed
    (b, h, s, d) views; the kernel reads their strides without a copy."""
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2, 70, 4, 32, generator=g).to(cuda)
    qt = x.transpose(1, 2)
    got = ops.flash_attention(qt, qt, qt)
    want = ref.attention(qt.contiguous(), qt.contiguous(), qt.contiguous())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_kv", [4, 2])
def test_reduced_serve_on_card_equals_cpu(n_kv, cuda):
    cfg = dataclasses.replace(reduced(get_config("llama-7b")), n_kv_heads=n_kv)
    cpu_params = tf.init_params(cfg, seed=0, device="cpu")
    gpu_params = _to(cpu_params, cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 37)).astype(np.int32)
    ops.reset_launch_counts()
    g_gpu, _ = port_serve.serve(cfg, prompts, max_new=5, params=gpu_params, device="cuda")
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    g_cpu, _ = port_serve.serve(cfg, prompts, max_new=5, params=cpu_params, device="cpu")
    np.testing.assert_array_equal(g_gpu, g_cpu)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# matmul kernel (tolerances of tests/test_kernels.py: f32 1e-4, bf16 3e-2,
# atol x8)
# ---------------------------------------------------------------------------

MM_CASES = [
    (128, 128, 128, "float32"), (256, 384, 128, "float32"),     # test_kernels.py
    (128, 256, 512, "bfloat16"), (64, 64, 64, "float32"),
    (200, 300, 77, "float32"), (200, 300, 77, "bfloat16"),      # ragged
    (1, 5, 3, "float32"), (130, 17, 129, "bfloat16"),
]
MM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _mm_inputs(m, k, n, dt, cuda, seed=0):
    rng = np.random.default_rng(seed)
    x, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device=cuda, dtype=getattr(torch, dt)) for s in ((m, k), (k, n)))
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,dt", MM_CASES)
def test_cuda_matmul_matches_plain_version(m, k, n, dt, cuda):
    x, w = _mm_inputs(m, k, n, dt, cuda)
    before = ops.launch_counts()["matmul"]
    got = ops.matmul(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul"] == before + 1
    assert got.dtype == x.dtype and got.shape == (m, n)
    want = ref.matmul(x, w)
    tol = MM_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol * 8)


GMM_CASES = [  # (e, c, k, n)
    (4, 128, 256, 128), (8, 128, 128, 384), (2, 256, 128, 128),  # tests/test_kernels.py
    (3, 200, 77, 130), (2, 1, 5, 3), (5, 33, 130, 17),           # ragged
]


def _gmm_inputs(e, c, k, n, dt, cuda, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device=cuda, dtype=getattr(torch, dt)) for s in ((e, c, k), (e, k, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,k,n", GMM_CASES)
def test_cuda_gmm_matches_plain_version(e, c, k, n, dt, cuda):
    x, w = _gmm_inputs(e, c, k, n, dt, cuda)
    before = ops.launch_counts()["gmm"]
    got = ops.gmm(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gmm"] == before + 1
    assert got.dtype == x.dtype and got.shape == (e, c, n)
    tol = MM_TOL[dt]
    torch.testing.assert_close(got.float(), ref.gmm(x, w).float(), rtol=tol,
                               atol=tol * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_gmm_takes_expert_strided_views(dt, cuda):
    """A weight view out of a stacked (e, units, k, n) tensor and a
    transposed x are read through their strides."""
    x, w = _gmm_inputs(5, 150, 96, 70, dt, cuda, seed=1)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    stacked = torch.stack([-w, w], dim=1)
    got = ops.gmm(xt, stacked[:, 1])
    tol = MM_TOL[dt]
    torch.testing.assert_close(got.float(), ref.gmm(x, w).float(), rtol=tol,
                               atol=tol * 8)


@pytest.mark.gpu
def test_reduced_moe_serve_on_card_matches_cpu(cuda):
    """Reduced qwen2-moe (pad experts, shared expert), float32: the gmm
    kernel path on the card against the plain path on the CPU."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), dtype="float32",
                              n_experts=6)
    params = tf.init_params(cfg, seed=0, device="cpu")
    gpu = _to(params, cuda)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    ops.reset_launch_counts()
    got, _ = port_serve.serve(cfg, prompts, max_new=4, params=gpu, device=cuda)
    assert ops.launch_counts()["gmm"] == 3 * cfg.n_layers * 4
    want, _ = port_serve.serve(cfg, prompts, max_new=4, params=params, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_matmul_takes_strided_views(dt, cuda):
    """Transposed and sliced operands are read through their strides."""
    x, w = _mm_inputs(150, 96, 70, dt, cuda, seed=1)
    xt = x.t().contiguous().t()                  # column-major x
    ws = torch.stack([w, -w], dim=2).flatten(1)[:, ::2]  # w, column stride 2
    got = ops.matmul(xt, ws)
    want = ref.matmul(x, w)
    tol = MM_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * 8)


# ---------------------------------------------------------------------------
# ring-attention step kernel: chained over r blocks from every rotation
# offset, against the plain chain and the forward kernel
# ---------------------------------------------------------------------------

STEP_CASES = [  # (b, hq, hkv, s, d, causal, window, dtype)
    (2, 4, 4, 64, 32, True, 0, "float32"),
    (2, 4, 2, 64, 32, True, 0, "float32"),     # GQA
    (1, 4, 1, 96, 64, True, 24, "float32"),    # window, MQA
    (1, 4, 2, 64, 16, False, 0, "float32"),
    (2, 4, 2, 128, 64, True, 0, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "h{}k{}s{}d{}{}w{}{}".format(
    c[1], c[2], c[3], c[4], "c" if c[5] else "", c[6], c[7][:2]))
def test_cuda_step_chain_matches_plain_every_offset(case, r, cuda):
    b, hq, hkv, s, d, causal, window, dt = case
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        device=cuda, dtype=getattr(torch, dt))
        for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    blk, tol = s // r, TOL[dt]
    kw = dict(causal=causal, window=window)
    for start in range(r):
        carry = plain = None
        for t in range(r):
            j = (start - t) % r
            kb, vb = k[:, :, j * blk:(j + 1) * blk], v[:, :, j * blk:(j + 1) * blk]
            plain = ref.attention_step(q, kb, vb, plain, kv_offset=j * blk, **kw)
            carry = ops.flash_attention_step(q, kb, vb, carry, kv_offset=j * blk, **kw)
            torch.cuda.synchronize()
            for got, want in zip(carry, plain):
                torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        out = ops.attention_finalize(carry, q.dtype)
        fwd = ops.flash_attention(q, k, v, **kw)
        np.testing.assert_allclose(out.float().cpu().numpy(), fwd.float().cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_step_updates_carry_in_place(cuda):
    q = torch.randn(1, 2, 40, 16, device=cuda)
    k = torch.randn(1, 2, 24, 16, device=cuda)
    carry = ops.flash_attention_step(q, k, k, None, kv_offset=16)
    m_ptr = carry[0].data_ptr()
    before = ops.launch_counts()["flash_attention_step"]
    again = ops.flash_attention_step(q, k, k, carry, kv_offset=0)
    assert again[0].data_ptr() == m_ptr
    assert ops.launch_counts()["flash_attention_step"] == before + 1


@pytest.mark.gpu
def test_reduced_llama_program_on_card_runs_through_kernels(cuda):
    """The explicit-collective executor on the one-card mesh: every clean
    contraction through the matmul kernel, attention through the flash
    kernel; logits equal the dense run's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    cfg = reduced(get_config("llama-7b"))
    prog = program_for(cfg, ShapeConfig("eq", "prefill", 64, 2))
    g = prog.graph
    rng = np.random.default_rng(0)
    feeds = {n.name: (rng.integers(0, cfg.vocab, size=n.shape).astype(np.int32)
                      if str(np.dtype(n.dtype)) == "int32"
                      else (rng.normal(size=n.shape) * 0.05).astype(np.float32))
             for n in g.nodes if n.kind == "input"}
    mesh = Mesh({"data": 1, "model": 1}, device=cuda)
    run = prog.compile(mesh=mesh, executor="shard_map")
    ops.reset_launch_counts()
    got = run(feeds)["logits"]
    torch.cuda.synchronize()
    n_mm = sum(1 for n in g.nodes if n.kind == "einsum" and spmd._as_matmul(n.spec))
    assert ops.launch_counts() == {"flash_attention": 1, "flash_attention_step": 0,
                                   "matmul": n_mm, "gmm": 0}
    want = prog.compile(mesh_axes=mesh.sizes, device=cuda)(feeds)["logits"]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _ring_rank_on_card(rank, world):
    """One of the gloo ranks that share the card: sequence-sharded
    attention through the ring rule (blocks staged through the host)."""
    from repro_torch.core.decomp import Plan
    from repro_torch.core import engine
    from repro_torch.core.einsum import EinGraph
    from repro_torch.launch.mesh import Mesh

    b, h, k, s, d = 2, 4, 2, 64, 32
    g = EinGraph("ring")
    ids = [g.input(n, lab, shp) for n, lab, shp in (
        ("q", "b h s d", (b, h, s, d)), ("k", "b k s d", (b, k, s, d)),
        ("v", "b k s d", (b, k, s, d)))]
    o = g.opaque("flash_attention", ids, "b h s d", (b, h, s, d),
                 in_labels=[("b", "h", "s", "d"), ("b", "k", "s", "d"),
                            ("b", "k", "s", "d")],
                 shardable={"b", "h", "k", "s"},
                 comm=[{"kind": "ring", "label": "s", "input": i, "rule": "ring"}
                       for i in (1, 2)])
    plan = Plan(p=world, mode="mesh")
    for n in g.nodes:
        plan.d_by_node[n.nid] = {l: (world if l == "s" else 1) for l in n.labels}
        plan.axes_by_node[n.nid] = {} if n.kind == "input" else {"s": ("seq",)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    feeds = [torch.randn(g.nodes[i].shape, generator=gen, device="cuda") for i in ids]
    mesh = Mesh({"seq": world}, device="cuda:0")
    run = engine.make_runner(g, [o], plan=plan, mesh=mesh, executor="shard_map")
    ops.reset_launch_counts()
    got = run(*feeds)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = ops.flash_attention(*feeds)
    return launches, float((got - want).abs().max())


@pytest.mark.gpu
def test_gloo_ranks_sharing_the_card_run_the_ring(cuda, tmp_path):
    """Two gloo ranks on one card (NCCL takes one rank per card): the ring
    at r = 2 through the step kernel equals the forward kernel."""
    from repro_torch.launch.mesh import spawn

    for launches, err in spawn(2, _ring_rank_on_card, tmpdir=tmp_path):
        assert launches == {"flash_attention": 0, "flash_attention_step": 2,
                            "matmul": 0, "gmm": 0}
        assert err <= 2e-5


# ---------------------------------------------------------------------------
# The wgmma designs (bf16, TMA-addressable operands) and the shape rule that
# picks them: each call's design is read from the per-design launch counts
# ---------------------------------------------------------------------------

def _served_by(kernel: str, fn):
    """Run ``fn`` once; return its result and the design that served it."""
    before = ops.design_counts()[kernel]
    out = fn()
    torch.cuda.synchronize()
    after = ops.design_counts()[kernel]
    (which,) = [d for d in after if after[d] == before[d] + 1]
    assert sum(after.values()) == sum(before.values()) + 1
    return out, which


def _att_inputs(shape_q, shape_kv, cuda, dt="bfloat16", seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device=cuda, dtype=getattr(torch, dt)) for s in (shape_q, shape_kv, shape_kv))


def _check_flash(case, dt, design, cuda):
    """The forward at ``case`` (b, hq, hkv, sq, sk, d, causal, window) in
    ``dt``, served by ``design``, against ``ref.attention`` at ``dt``'s
    tolerance."""
    b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v = _att_inputs((b, hq, sq, d), (b, hkv, sk, d), cuda, dt)
    kw = dict(causal=causal, window=window, q_offset=sk - sq if causal else 0)
    got, which = _served_by("flash_attention", lambda: ops.flash_attention(q, k, v, **kw))
    assert which == design and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), ref.attention(q, k, v, **kw).float(),
                               rtol=TOL[dt], atol=TOL[dt])


def _check_flash_bshd_views(d, hkv, dt, design, cuda):
    """(b, s, h, d) projections reach the kernel as transposed views, which
    ``design`` reads through their strides, without a copy."""
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn(2, 333, 8, d, generator=g).to(cuda, getattr(torch, dt)).transpose(1, 2)
    k, v = (torch.randn(2, 333, hkv, d, generator=g).to(cuda, getattr(torch, dt)).transpose(1, 2)
            for _ in range(2))
    got, which = _served_by("flash_attention", lambda: ops.flash_attention(q, k, v))
    assert which == design
    want = ref.attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])


def _check_step_chain(case, r, dt, design, cuda):
    """The ring as each rank runs it: q block i at i*blk, the kv blocks in
    ring order, fully masked blocks included.  Every carry against the plain
    step (in natural units, so m and the -1e30 of masked rows compare
    directly), the finalised chain against the forward kernel."""
    b, hq, hkv, s, d, causal, window = case
    q, k, v = _att_inputs((b, hq, s, d), (b, hkv, s, d), cuda, dt, seed=2)
    blk, tol = s // r, TOL[dt]
    kw = dict(causal=causal, window=window)
    for i in range(r):
        qi = q[:, :, i * blk:(i + 1) * blk]
        carry = plain = None
        for t in range(r):
            j = (i - t) % r
            kj, vj = k[:, :, j * blk:(j + 1) * blk], v[:, :, j * blk:(j + 1) * blk]
            off = dict(q_offset=i * blk, kv_offset=j * blk, **kw)
            carry, which = _served_by("flash_attention_step", lambda: ops.flash_attention_step(
                qi, kj, vj, carry, **off))
            assert which == design
            plain = ref.attention_step(qi, kj, vj, plain, **off)
            for got, want in zip(carry, plain):
                torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        fin = ops.attention_finalize(carry, q.dtype)
        fwd = ops.flash_attention(qi, k, v, q_offset=i * blk, **kw)
        torch.testing.assert_close(fin.float(), fwd.float(), rtol=tol, atol=tol)


def _check_step_carry(dt, design, cuda):
    """``None`` starts from (-1e30, 0, 0) without reading the buffers; a
    given carry is read and written in place; a row with no key yet keeps
    m = -1e30 exactly and weighs its masked scores 1; a carry whose acc is
    not 16-byte aligned is copied, and the copy updated."""
    tol = TOL[dt]
    q, k, v = _att_inputs((1, 4, 150, 128), (1, 2, 130, 128), cuda, dt, seed=3)
    carry, which = _served_by("flash_attention_step", lambda: ops.flash_attention_step(
        q, k, v, None, q_offset=0, kv_offset=100))
    assert which == design
    want = ref.attention_step(q, k, v, None, q_offset=0, kv_offset=100)
    for got, w in zip(carry, want):
        torch.testing.assert_close(got, w, rtol=tol, atol=tol)
    assert bool((carry[0][:, :, :100] == -1e30).all())
    assert bool((carry[1][:, :, :100] == 130).all())
    ptrs = [t.data_ptr() for t in carry]
    again, which = _served_by("flash_attention_step", lambda: ops.flash_attention_step(
        q, k, v, carry, q_offset=0, kv_offset=0))
    assert which == design and [t.data_ptr() for t in again] == ptrs
    want = ref.attention_step(q, k, v, want, q_offset=0, kv_offset=0)
    for got, w in zip(again, want):
        torch.testing.assert_close(got, w, rtol=tol, atol=tol)
    m, l, acc = (t.clone() for t in want)
    flat = torch.empty(acc.numel() + 1, device=cuda)
    shifted = flat[1:].view(acc.shape)
    shifted.copy_(acc)
    out = ops.flash_attention_step(q, k, v, (m, l, shifted), q_offset=0, kv_offset=0)
    assert out[2].data_ptr() % 16 == 0 and out[0].data_ptr() == m.data_ptr()
    want = ref.attention_step(q, k, v, want, q_offset=0, kv_offset=0)
    for got, w in zip(out, want):
        torch.testing.assert_close(got, w, rtol=tol, atol=tol)


WG_ATT_CASES = [  # (b, hq, hkv, sq, sk, d, causal, window)
    (1, 4, 4, 128, 128, 64, True, 0),        # tests/test_kernels.py's bf16 case
    (1, 4, 2, 128, 128, 64, True, 0),        # its other cases at d = 64 and 128
    (2, 2, 1, 256, 256, 64, True, 64),
    (1, 2, 2, 128, 256, 64, False, 0),
    (1, 8, 1, 128, 128, 128, True, 0),
    (2, 4, 2, 64, 64, 64, True, 32),
    (4, 32, 32, 512, 512, 128, True, 0),     # llama-7b prefill
    (4, 16, 16, 512, 512, 128, True, 0),     # qwen2-moe prefill
    (2, 16, 4, 300, 300, 128, True, 0),      # GQA 4:1, ragged
    (1, 8, 2, 200, 333, 64, True, 40),       # window, ragged, sq < sk
    (1, 4, 4, 77, 77, 128, True, 0),         # shorter than a tile
    (1, 4, 4, 1, 130, 128, True, 0),         # one query row
    (1, 4, 1, 100, 260, 128, False, 0),      # MQA, no mask, ragged
]
# head dim 256 (64-key K/V tiles in the ring; only the forward)
WG_ATT_CASES_256 = [
    (4, 8, 1, 512, 512, 256, True, 0),       # paligemma-3b prefill, MQA 8:1
    (1, 8, 1, 512, 512, 256, True, 0),       # batch 1
    (2, 8, 4, 333, 333, 256, True, 0),       # GQA 2:1, ragged
    (1, 8, 1, 77, 333, 256, True, 0),        # ragged, sq < sk (q offset 256)
    (1, 8, 4, 260, 260, 256, True, 64),      # window, GQA 2:1, ragged
    (1, 4, 1, 100, 260, 256, False, 0),      # MQA, no mask, ragged
    (1, 4, 4, 1, 130, 256, True, 0),         # one query row
    (1, 4, 4, 64, 64, 256, True, 0),         # one key tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WG_ATT_CASES + WG_ATT_CASES_256,
                         ids=lambda c: "b{}h{}k{}q{}s{}d{}{}w{}".format(
                             c[0], c[1], c[2], c[3], c[4], c[5], "c" if c[6] else "", c[7]))
def test_cuda_flash_wgmma_matches_plain_version(case, cuda):
    _check_flash(case, "bfloat16", "wgmma", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("d,hkv", [(128, 8), (64, 2), (256, 1), (256, 4)])
def test_cuda_flash_wgmma_takes_bshd_views(d, hkv, cuda):
    """The tensor maps carry the views' strides."""
    _check_flash_bshd_views(d, hkv, "bfloat16", "wgmma", cuda)


MASKED_GPU_CASES = [  # (b, hq, hkv, sq, sk, causal, window, q_offset, kv_offset)
    (1, 4, 2, 128, 128, True, 0, 0, 64),
    (1, 4, 4, 256, 256, True, 0, 0, 100),
    (2, 8, 2, 256, 256, True, 8, 0, 120),
    (1, 4, 2, 128, 256, False, 64, 250, 0),
    (1, 2, 1, 128, 256, True, 16, 300, 0),
    (1, 4, 1, 300, 200, True, 0, 0, 150),    # ragged: partial blocks
]


def _misaligned(t):
    """``t``'s values at a base one element past its own (2 or 4 bytes off
    16): no 16-byte copy addresses it."""
    flat = torch.cat([t.flatten(), t.flatten()[:1]])
    return flat[1:].view(t.shape).copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,d,design", [("bfloat16", 64, "wgmma"),
                                         ("bfloat16", 128, "wgmma"),
                                         ("float32", 64, "ffma"),
                                         ("float32", 128, "ffma"),
                                         ("float32", 256, "ffma"),
                                         ("float32_misaligned", 64, "template"),
                                         ("bfloat16", 256, "wgmma"),
                                         ("bfloat16_misaligned", 256, "template")])
@pytest.mark.parametrize("case", MASKED_GPU_CASES, ids=lambda c: "q{}s{}{}w{}qo{}ko{}".format(
    c[3], c[4], "c" if c[5] else "", c[6], c[7], c[8]))
def test_cuda_flash_fully_masked_rows_follow_the_tile_convention(case, dt, d, design, cuda):
    """Rows that see no key: every forward design gives what the TPU kernel
    gives at its 128 x 128 blocks (``ref.attention_tiled``)."""
    b, hq, hkv, sq, sk, causal, window, qo, ko = case
    misaligned = dt.endswith("_misaligned")
    dt = dt.removesuffix("_misaligned")
    q, k, v = _att_inputs((b, hq, sq, d), (b, hkv, sk, d), cuda, dt)
    if misaligned:
        q = _misaligned(q)
    kw = dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)
    got, which = _served_by("flash_attention", lambda: ops.flash_attention(q, k, v, **kw))
    assert which == design
    tol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.attention_tiled(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["misaligned_base", "rows_not_16_bytes", "expanded_kv",
                                  "head_dim_256_misaligned_base", "head_dim_32", "float32"])
def test_cuda_flash_shapes_outside_the_rule_take_the_template(name, cuda):
    """bf16 operands the rule refuses, and a float32 one (a base 4 bytes
    off 16), take the template."""
    q, k, v = _att_inputs((1, 4, 150, 128), (1, 4, 150, 128), cuda)
    if name == "misaligned_base":
        q = torch.cat([q.flatten(), q.flatten()[:1]])[1:].view(q.shape)
    elif name == "rows_not_16_bytes":
        q, k, v = (torch.nn.functional.pad(t, (0, 4))[..., :64] for t in (q, k, v))
    elif name == "expanded_kv":
        k, v = k[:, :1].expand_as(k), v[:, :1].expand_as(v)
    elif name == "head_dim_256_misaligned_base":
        q, k, v = (torch.cat([t, -t], dim=-1) for t in (q, k, v))
        q = _misaligned(q)
    elif name == "head_dim_32":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    else:  # float32, misaligned
        q, k, v = (t.float() for t in (q, k, v))
        q = _misaligned(q)
    got, which = _served_by("flash_attention", lambda: ops.flash_attention(q, k, v))
    assert which == "template"
    tol = TOL[str(q.dtype).split(".")[1]]
    torch.testing.assert_close(got.float(), ref.attention(q, k, v).float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_wgmma_designs_give_the_same_bits_twice(cuda):
    """No atomics and no split-K: two launches on the same inputs give the
    same bits, for each wgmma kernel at its path shape."""
    q, k, v = _att_inputs((4, 32, 512, 128), (4, 32, 512, 128), cuda)
    a = ops.flash_attention(q, k, v)
    assert torch.equal(a, ops.flash_attention(q, k, v))
    q, k, v = _att_inputs((4, 8, 512, 256), (4, 1, 512, 256), cuda)  # paligemma's
    a = ops.flash_attention(q, k, v)
    assert torch.equal(a, ops.flash_attention(q, k, v))
    x, w = _mm_inputs(2048, 4096, 4096, "bfloat16", cuda)
    assert torch.equal(ops.matmul(x, w), ops.matmul(x, w))
    xe, we = _gmm_inputs(64, 256, 2048, 1408, "bfloat16", cuda)
    assert torch.equal(ops.gmm(xe, we), ops.gmm(xe, we))
    assert mm.design(x, w) == mm.design(xe, we) == "wgmma"


def _llama_mm_shapes():
    cfg = get_config("llama-7b")
    d, m = cfg.d_model, 4 * 512
    return [(m, d, cfg.n_heads * cfg.head_dim), (m, d, cfg.d_ff), (m, cfg.d_ff, d),
            (m, d, cfg.vocab_padded)]


WG_MM_CASES = ([(128, 256, 512), (200, 296, 72), (130, 24, 136), (1, 64, 8), (77, 8, 296)]
               + _llama_mm_shapes())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", WG_MM_CASES)
def test_cuda_matmul_wgmma_matches_plain_version(m, k, n, cuda):
    x, w = _mm_inputs(m, k, n, "bfloat16", cuda)
    w = w * k ** -0.5
    got, which = _served_by("matmul", lambda: ops.matmul(x, w))
    assert which == "wgmma" and got.shape == (m, n)
    torch.testing.assert_close(got.float(), ref.matmul(x, w).float(), rtol=3e-2, atol=0.24)


@pytest.mark.gpu
@pytest.mark.parametrize("x_t,w_t", [(False, False), (True, False), (False, True),
                                     (True, True)])
def test_cuda_matmul_wgmma_reads_both_majors(x_t, w_t, cuda):
    """K-major or M-major x, N-major or K-major w: each through its own
    tensor map and wgmma's transpose bits, without a copy."""
    x, w = _mm_inputs(328, 200, 264, "bfloat16", cuda, seed=4)
    xv = x.t().contiguous().t() if x_t else x
    wv = w.t().contiguous().t() if w_t else w
    assert mm.layouts(xv, wv) == (int(x_t), int(not w_t))
    got, which = _served_by("matmul", lambda: ops.matmul(xv, wv))
    assert which == "wgmma"
    torch.testing.assert_close(got.float(), ref.matmul(x, w).float(), rtol=3e-2, atol=0.24)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rows_not_16_bytes", "misaligned_base", "column_stride_2"])
def test_cuda_matmul_shapes_outside_the_rule_take_the_template(name, cuda):
    x, w = _mm_inputs(130, 17, 129, "bfloat16", cuda)
    if name == "misaligned_base":
        x, w = _mm_inputs(64, 64, 64, "bfloat16", cuda)
        x = torch.cat([x.flatten(), x.flatten()[:1]])[1:].view(x.shape)
    elif name == "column_stride_2":
        x, w = _mm_inputs(64, 64, 64, "bfloat16", cuda)
        w = torch.stack([w, -w], dim=2).flatten(1)[:, ::2]
    got, which = _served_by("matmul", lambda: ops.matmul(x, w))
    assert which == "template"
    torch.testing.assert_close(got.float(), ref.matmul(x, w).float(), rtol=3e-2, atol=0.24)


def _moe_gmm_shapes():
    from repro_torch.models.moe import _capacity

    q, mx = get_config("qwen2-moe-a2.7b"), get_config("mixtral-8x7b")
    cp, cd = _capacity(2048, q), _capacity(4, q)
    mp = _capacity(2048, mx)
    return [(q.n_e, cp, q.d_model, q.d_ff), (q.n_e, cp, q.d_ff, q.d_model),
            (q.n_e, cd, q.d_model, q.d_ff), (mx.n_e, mp, mx.d_model, 1024),
            # mixtral-8x7b's w2 at b=4, s=512 and its w1 in a decode step
            (mx.n_e, mp, mx.d_ff, mx.d_model), (mx.n_e, _capacity(4, mx), mx.d_model, mx.d_ff)]


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,n", [(4, 128, 256, 128), (8, 128, 128, 384), (2, 256, 128, 128),
                                     (5, 33, 136, 24)] + _moe_gmm_shapes())
def test_cuda_gmm_wgmma_matches_plain_version(e, c, k, n, cuda):
    x, w = _gmm_inputs(e, c, k, n, "bfloat16", cuda)
    w = w * k ** -0.5
    got, which = _served_by("gmm", lambda: ops.gmm(x, w))
    assert which == "wgmma" and got.shape == (e, c, n)
    torch.testing.assert_close(got.float(), ref.gmm(x, w).float(), rtol=3e-2, atol=0.24)


@pytest.mark.gpu
def test_cuda_gmm_wgmma_takes_expert_strided_views(cuda):
    """A weight view out of a stacked (e, units, k, n) tensor (the expert
    stride steps over the other units) and an M-major x."""
    x, w = _gmm_inputs(5, 152, 96, 72, "bfloat16", cuda, seed=1)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    stacked = torch.stack([-w, w, -w], dim=1)
    assert mm.layouts(xt, stacked[:, 1]) == (1, 1)
    got, which = _served_by("gmm", lambda: ops.gmm(xt, stacked[:, 1]))
    assert which == "wgmma"
    torch.testing.assert_close(got.float(), ref.gmm(x, w).float(), rtol=3e-2, atol=0.24)
    xs = x[:, :, :77].contiguous()  # 77-element rows: not 16-byte multiples
    got, which = _served_by("gmm", lambda: ops.gmm(xs, w[:, :77]))
    assert which == "template"
    torch.testing.assert_close(got.float(), ref.gmm(xs, w[:, :77]).float(),
                               rtol=3e-2, atol=0.24)


# ---------------------------------------------------------------------------
# The ffma design (float32 matmul and gmm under the same rule) and the ring
# step's wgmma design
# ---------------------------------------------------------------------------

FFMA_MM_CASES = [(128, 128, 128), (256, 384, 128), (64, 64, 64),  # test_kernels.py
                 (200, 300, 76), (1, 4, 4), (130, 20, 132), (77, 8, 296),
                 (300, 1000, 4)] + _llama_mm_shapes()[:1]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", FFMA_MM_CASES)
def test_cuda_matmul_ffma_matches_plain_version(m, k, n, cuda):
    x, w = _mm_inputs(m, k, n, "float32", cuda)
    got, which = _served_by("matmul", lambda: ops.matmul(x, w))
    assert which == "ffma" and got.shape == (m, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.matmul(x, w), rtol=1e-4, atol=8e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("x_t,w_t", [(False, False), (True, False), (False, True),
                                     (True, True)])
@pytest.mark.parametrize("m,k,n", [(328, 200, 264), (132, 36, 260)])
def test_cuda_matmul_ffma_reads_both_majors(x_t, w_t, m, k, n, cuda):
    """K-major or M-major x, N-major or K-major w, ragged edges: 16-byte
    copies of an MN-major operand, transposing 4-byte copies of a K-major
    one, without a copy of the operand."""
    x, w = _mm_inputs(m, k, n, "float32", cuda, seed=4)
    xv = x.t().contiguous().t() if x_t else x
    wv = w.t().contiguous().t() if w_t else w
    assert mm.layouts(xv, wv) == (int(x_t), int(not w_t))
    got, which = _served_by("matmul", lambda: ops.matmul(xv, wv))
    assert which == "ffma"
    torch.testing.assert_close(got, ref.matmul(x, w), rtol=1e-4, atol=8e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rows_of_130_floats", "misaligned_base", "column_stride_2"])
def test_cuda_matmul_f32_shapes_outside_the_rule_take_the_template(name, cuda):
    x, w = _mm_inputs(77, 130, 64, "float32", cuda)
    if name == "misaligned_base":
        x, w = _mm_inputs(64, 64, 64, "float32", cuda)
        x = torch.cat([x.flatten(), x.flatten()[:1]])[1:].view(x.shape)
    elif name == "column_stride_2":
        x, w = _mm_inputs(64, 64, 64, "float32", cuda)
        w = torch.stack([w, -w], dim=2).flatten(1)[:, ::2]
    got, which = _served_by("matmul", lambda: ops.matmul(x, w))
    assert which == "template"
    torch.testing.assert_close(got, ref.matmul(x, w), rtol=1e-4, atol=8e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,n", [(4, 128, 256, 128), (8, 128, 128, 384), (2, 256, 128, 128),
                                     (5, 33, 136, 24), (3, 200, 76, 132)]
                         + _moe_gmm_shapes()[:1])
def test_cuda_gmm_ffma_matches_plain_version(e, c, k, n, cuda):
    x, w = _gmm_inputs(e, c, k, n, "float32", cuda)
    got, which = _served_by("gmm", lambda: ops.gmm(x, w))
    assert which == "ffma" and got.shape == (e, c, n)
    torch.testing.assert_close(got, ref.gmm(x, w), rtol=1e-4, atol=8e-4)


@pytest.mark.gpu
def test_cuda_gmm_ffma_takes_expert_strided_views(cuda):
    """A weight view out of a stacked (e, units, k, n) tensor, a K-major
    weight and an M-major x, each read through its strides; an x whose rows
    are not 16-byte multiples takes the template."""
    x, w = _gmm_inputs(5, 152, 96, 72, "float32", cuda, seed=1)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    stacked = torch.stack([-w, w, -w], dim=1)
    assert mm.layouts(xt, stacked[:, 1]) == (1, 1)
    got, which = _served_by("gmm", lambda: ops.gmm(xt, stacked[:, 1]))
    assert which == "ffma"
    torch.testing.assert_close(got, ref.gmm(x, w), rtol=1e-4, atol=8e-4)
    wk = w.transpose(1, 2).contiguous().transpose(1, 2)
    assert mm.layouts(x, wk) == (0, 0)
    got, which = _served_by("gmm", lambda: ops.gmm(x, wk))
    assert which == "ffma"
    torch.testing.assert_close(got, ref.gmm(x, w), rtol=1e-4, atol=8e-4)
    xs = x[:, :, :77].contiguous()  # 77-float rows: not 16-byte multiples
    got, which = _served_by("gmm", lambda: ops.gmm(xs, w[:, :77]))
    assert which == "template"
    torch.testing.assert_close(got, ref.gmm(xs, w[:, :77]), rtol=1e-4, atol=8e-4)


@pytest.mark.gpu
def test_cuda_ffma_and_step_designs_give_the_same_bits_twice(cuda):
    """No atomics and no split-K: two launches on the same inputs give the
    same bits, for the ffma design at its path shapes and the step's wgmma
    design at the ring shape."""
    x, w = _mm_inputs(2048, 4096, 4096, "float32", cuda)
    assert torch.equal(ops.matmul(x, w), ops.matmul(x, w))
    xe, we = _gmm_inputs(64, 256, 2048, 1408, "float32", cuda)
    assert torch.equal(ops.gmm(xe, we), ops.gmm(xe, we))
    assert mm.design(x, w) == mm.design(xe, we) == "ffma"
    q, k, v = _att_inputs((4, 32, 128, 128), (4, 32, 128, 128), cuda)
    kw = dict(q_offset=384, kv_offset=128)
    a = ops.flash_attention_step(q, k, v, None, **kw)
    b = ops.flash_attention_step(q, k, v, None, **kw)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


WG_STEP_CASES = [  # (b, hq, hkv, s, d, causal, window)
    (2, 4, 2, 128, 64, True, 0),       # the bf16 case of STEP_CASES
    (2, 4, 4, 256, 128, True, 0),
    (1, 8, 2, 200, 128, True, 40),     # GQA 4:1, window, blocks that divide no tile
    (1, 4, 1, 96, 64, True, 24),       # MQA, window
    (1, 4, 2, 512, 64, False, 0),      # no mask, two kv tiles a block at r = 2
    (4, 32, 32, 512, 128, True, 0),    # llama-7b prefill cut r ways
]


@pytest.mark.gpu
@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("case", WG_STEP_CASES, ids=lambda c: "b{}h{}k{}s{}d{}{}w{}".format(
    c[0], c[1], c[2], c[3], c[4], "c" if c[5] else "", c[6]))
def test_cuda_step_wgmma_chain_matches_plain_every_offset(case, r, cuda):
    _check_step_chain(case, r, "bfloat16", "wgmma", cuda)


@pytest.mark.gpu
def test_cuda_step_wgmma_updates_carry_in_place_and_init(cuda):
    _check_step_carry("bfloat16", "wgmma", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [2, 4])
def test_cuda_step_at_head_dim_256_takes_the_template(r, cuda):
    """The step's wgmma design stops at head dim 128: a bf16 ring step at
    256 launches the template, and its finalised chain equals the forward,
    which takes the wgmma design there."""
    _check_step_chain((1, 8, 1, 256, 256, True, 0), r, "bfloat16", "template", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [2, 4])
def test_cuda_f32_step_at_head_dim_256_takes_the_template(r, cuda):
    """The step's ffma design stops at head dim 128 too: a float32 ring
    step at 256 launches the template, and its finalised chain equals the
    forward, which takes the ffma design there."""
    _check_step_chain((1, 8, 1, 256, 256, True, 0), r, "float32", "template", cuda)


# ---------------------------------------------------------------------------
# The flash forward's and the ring step's ffma design (float32, head dim 64
# and 128, the forward also 256, operands the rule addresses), at the
# float32 tolerance 2e-5
# ---------------------------------------------------------------------------

FFMA_ATT_CASES = WG_ATT_CASES + [  # (b, hq, hkv, sq, sk, d, causal, window)
    (1, 32, 32, 512, 512, 128, True, 0),     # an engine prefill
    (1, 4, 2, 160, 96, 64, False, 0),        # cross, sk < sq
    # head dim 256: 32-row q tiles; where the grid has fewer q tiles than the
    # card has SMs (every case here but the prefill shape and the GQA 2:1
    # one), a cluster of two blocks each
    (1, 8, 1, 320, 320, 256, True, 0),       # paligemma-3b's f32 slice, MQA 8:1
    (4, 8, 1, 512, 512, 256, True, 0),       # paligemma-3b's prefill shape
    (2, 8, 4, 333, 333, 256, True, 0),       # GQA 2:1, ragged
    (1, 8, 1, 77, 333, 256, True, 0),        # ragged, sq < sk (q offset 256)
    (1, 8, 4, 260, 260, 256, True, 64),      # window, GQA 2:1, ragged
    (1, 4, 4, 1, 130, 256, True, 0),         # one query row
    (1, 4, 2, 160, 96, 256, False, 0),       # cross, sk < sq
    (1, 4, 1, 100, 260, 256, False, 0),      # MQA, no mask, ragged
    (1, 4, 4, 32, 32, 256, True, 0),         # one q tile, one key tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FFMA_ATT_CASES, ids=lambda c: "b{}h{}k{}q{}s{}d{}{}w{}".format(
    c[0], c[1], c[2], c[3], c[4], c[5], "c" if c[6] else "", c[7]))
def test_cuda_flash_ffma_matches_plain_version(case, cuda):
    _check_flash(case, "float32", "ffma", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("d,hkv", [(128, 8), (64, 2), (256, 1), (256, 4)])
def test_cuda_flash_ffma_takes_bshd_views(d, hkv, cuda):
    """float32 rows read through the views' strides by 16-byte copies."""
    _check_flash_bshd_views(d, hkv, "float32", "ffma", cuda)



@pytest.mark.gpu
@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("case", WG_STEP_CASES, ids=lambda c: "b{}h{}k{}s{}d{}{}w{}".format(
    c[0], c[1], c[2], c[3], c[4], "c" if c[5] else "", c[6]))
def test_cuda_step_ffma_chain_matches_plain_every_offset(case, r, cuda):
    _check_step_chain(case, r, "float32", "ffma", cuda)


@pytest.mark.gpu
def test_cuda_step_ffma_updates_carry_in_place_and_init(cuda):
    _check_step_carry("float32", "ffma", cuda)


@pytest.mark.gpu
def test_cuda_flash_ffma_designs_give_the_same_bits_twice(cuda):
    """No atomics: two launches of the ffma forward at the executor's shape
    and at paligemma's float32 slice (head dim 256, where the two blocks of
    a cluster split each q tile's keys and combine in a fixed order), and
    of the ffma step at the f32 ring's, give the same bits."""
    q, k, v = _att_inputs((4, 32, 512, 128), (4, 32, 512, 128), cuda, "float32")
    a = ops.flash_attention(q, k, v)
    assert torch.equal(a, ops.flash_attention(q, k, v))
    q, k, v = _att_inputs((1, 8, 320, 256), (1, 1, 320, 256), cuda, "float32")
    a, which = _served_by("flash_attention", lambda: ops.flash_attention(q, k, v))
    assert which == "ffma" and torch.equal(a, ops.flash_attention(q, k, v))
    q, k, v = _att_inputs((4, 32, 128, 128), (4, 32, 128, 128), cuda, "float32")
    kw = dict(q_offset=384, kv_offset=128)
    a = ops.flash_attention_step(q, k, v, None, **kw)
    b = ops.flash_attention_step(q, k, v, None, **kw)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


# ---------------------------------------------------------------------------
# gradients: backward through ops.flash_attention, ops.matmul and ops.gmm
# (the kernels' autograd Functions, whose backward is the plain version's)
# against the plain versions' own gradients, at the kernel tolerances
# ---------------------------------------------------------------------------

def _grads_through(fn, ins, seed=3):
    """(output, gradients of <output, ct> for the inputs that require
    grad): ``ct`` a fixed seeded cotangent, so the two paths differ only in
    what their backward computes."""
    out = fn(*ins)
    ct = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(out.shape)).astype(np.float32)).to(out.device, out.dtype)
    wrt = [t for t in ins if t.requires_grad]
    return out, torch.autograd.grad(out, wrt, ct)


GRAD_ATT_CASES = [  # (b, hq, hkv, sq, sk, d, causal, window, dtype, design)
    (2, 8, 2, 256, 256, 128, True, 0, "bfloat16", "wgmma"),      # GQA 4:1
    (1, 4, 4, 200, 200, 64, True, 64, "bfloat16", "wgmma"),      # window, ragged
    (1, 4, 2, 128, 128, 64, True, 0, "float32", "ffma"),
    (2, 2, 1, 96, 96, 32, True, 24, "float32", "template"),     # window, GQA
    (1, 2, 2, 64, 160, 64, False, 0, "float32", "ffma"),        # cross
    (1, 8, 1, 200, 200, 256, True, 0, "bfloat16", "wgmma"),     # head dim 256, MQA 8:1
    (2, 8, 4, 128, 128, 256, True, 32, "bfloat16", "wgmma"),    # head dim 256, GQA, window
    (1, 8, 1, 200, 200, 256, True, 0, "float32", "ffma"),       # head dim 256, MQA 8:1
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRAD_ATT_CASES, ids=lambda c: "h{}k{}q{}s{}d{}w{}{}".format(
    c[1], c[2], c[3], c[4], c[5], c[7], c[8][:2]))
def test_cuda_flash_backward_matches_plain_gradients(case, cuda):
    b, hq, hkv, sq, sk, d, causal, window, dt, design = case
    # the projections reach attention as (b, s, h, d) views, transposed
    q, k, v = (t.transpose(1, 2).detach().requires_grad_()
               for t in _att_inputs((b, sq, hq, d), (b, sk, hkv, d), cuda, dt))
    kw = dict(causal=causal, window=window, q_offset=sk - sq if causal else 0)
    (out, got), which = _served_by("flash_attention", lambda: _grads_through(
        lambda q, k, v: ops.flash_attention(q, k, v, **kw), (q, k, v)))
    assert which == design and out.grad_fn is not None
    _, want = _grads_through(lambda q, k, v: ref.attention(q, k, v, **kw), (q, k, v))
    tol = TOL[dt]
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,design", [("float32", "ffma"), ("bfloat16", "wgmma")])
@pytest.mark.parametrize("layout", ["plain", "x_t", "w_t", "w_col_stride_2"])
def test_cuda_matmul_backward_matches_plain_gradients(layout, dt, design, cuda):
    x, w = _mm_inputs(192, 96, 144, dt, cuda, seed=2)
    if layout == "x_t":
        x = x.t().contiguous().t()
    elif layout == "w_t":
        w = w.t().contiguous().t()
    elif layout == "w_col_stride_2":
        w = torch.stack([w, -w], dim=2).flatten(1)[:, ::2]
        design = "template"
    x, w = x.requires_grad_(), w.requires_grad_()
    (out, got), which = _served_by("matmul", lambda: _grads_through(ops.matmul, (x, w)))
    assert which == design and out.grad_fn is not None
    _, want = _grads_through(ref.matmul, (x, w))
    tol = MM_TOL[dt]
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g.float(), wnt.float(), rtol=tol, atol=tol * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,design", [("float32", "ffma"), ("bfloat16", "wgmma")])
def test_cuda_gmm_backward_matches_plain_gradients(dt, design, cuda):
    x, w = _gmm_inputs(4, 128, 256, 128, dt, cuda, seed=4)
    w = torch.stack([w, w], dim=1)[:, 0]  # one unit of a stacked parameter
    x, w = x.requires_grad_(), w.detach().requires_grad_()
    (out, got), which = _served_by("gmm", lambda: _grads_through(ops.gmm, (x, w)))
    assert which == design and out.grad_fn is not None
    _, want = _grads_through(ref.gmm, (x, w))
    tol = MM_TOL[dt]
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g.float(), wnt.float(), rtol=tol, atol=tol * 8)


@pytest.mark.gpu
def test_cuda_step_raises_under_grad(cuda):
    q, k, v = _att_inputs((1, 4, 128, 128), (1, 4, 128, 128), cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.flash_attention_step(q.requires_grad_(), k, v)
    with torch.no_grad():
        m, l, acc = ops.flash_attention_step(q, k, v)
    assert not acc.requires_grad


@pytest.mark.gpu
def test_reduced_train_step_on_card_matches_cpu(cuda):
    """Two train steps of reduced llama in float32: the card (the flash
    kernel forward, its Function's backward) against the CPU (the plain
    path), the same weights and batches."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(reduced(get_config("llama-7b")), dtype="float32")
    cpu_params = tf.init_params(cfg, seed=0, device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):  # the CPU run updates cpu_params in place
        params = _to(cpu_params, dev)
        state = adamw_init(params)
        step = steps.make_train_step(cfg)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, size=(2, 64)), device=dev)
        before = ops.launch_counts()["flash_attention"]
        losses = []
        for _ in range(2):
            params, state, met = step(params, state, {"tokens": toks, "labels": toks})
            losses.append(float(met["loss"]))
        launches = ops.launch_counts()["flash_attention"] - before
        res[dev] = (losses, launches)
    # remat: one forward launch and one recompute a layer a step
    assert res["cuda"][1] == 2 * 2 * cfg.n_layers and res["cpu"][1] == 0
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-4)


def _engine_run(cfg, params, prompts, max_new, device):
    """The serving engine on ``device`` (2 slots, blocks of 8): its
    generations and, for every decode step, the last-position logits of
    the slots that held a request.  The step is the registry's (the paged
    decode step, then a greedy argmax on the device), with the logits
    copied out on the way: a host read, so the step runs eagerly
    (``graph=False``; the graphed step against it:
    ``test_graphed_engine_equals_eager_engine_on_card``)."""
    from repro_torch.launch import steps
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(cfg, batch=2, max_seq=40, block=8, params=params, device=device,
                        graph=False)
    base = steps.make_paged_serve_step(cfg)
    logs = []

    def decode(params, tokens, caches, tables, pos):
        logits, caches = base(params, tokens, caches, tables, pos)
        live = [i for i, s in enumerate(eng.slots) if s is not None]
        logs.append(logits[live, -1].float().cpu())
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32), caches

    eng._decode = decode
    for p, n in zip(prompts, max_new):
        eng.submit(p, n)
    res, metrics = eng.run()
    return res, logs, metrics


@pytest.mark.gpu
@pytest.mark.parametrize("n_kv", [4, 2])
def test_reduced_engine_on_card_equals_cpu(n_kv, cuda):
    """The continuous-batching engine, reduced llama in float32 (mha and
    gqa): three requests through two slots on the card (the flash kernel in
    every bucketed prefill) and on the CPU, the same weights and prompts.
    Tokens equal; decode logits within 1e-4 of max|logit| (float32 sums in
    another order)."""
    cfg = dataclasses.replace(reduced(get_config("llama-7b")), n_kv_heads=n_kv,
                              dtype="float32")
    params = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in (21, 9, 30)]
    max_new = (6, 9, 5)
    ops.reset_launch_counts()
    got, got_logs, m = _engine_run(cfg, params, prompts, max_new, cuda)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers * m.prefills == 3 * cfg.n_layers
    want, want_logs, _ = _engine_run(cfg, params, prompts, max_new, "cpu")
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert len(got_logs) == len(want_logs) == m.decode_steps
    scale = max(float(w.abs().max()) for w in want_logs)
    for g, w in zip(got_logs, want_logs):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


ZOO_ATT_CASES = [  # ((b, hq, hkv, sq, sk, d, causal, window), dtype, design)
    ((1, 25, 5, 2048, 2048, 64, True, 1024), "bfloat16", "wgmma"),    # hymba prefill, GQA 5:1
    ((2, 25, 5, 1337, 1337, 64, True, 1024), "bfloat16", "wgmma"),    # ragged, window binds
    ((1, 25, 5, 1280, 1280, 64, True, 1024), "float32", "ffma"),      # hymba f32 parity
    ((2, 8, 1, 512, 512, 256, True, 0), "bfloat16", "wgmma"),         # paligemma, MQA 8:1
    ((1, 8, 1, 260, 260, 256, True, 0), "float32", "ffma"),           # f32, ragged
    ((1, 36, 36, 256, 256, 64, True, 0), "bfloat16", "wgmma"),        # minicpm, 36 heads of 64
    ((1, 36, 36, 256, 256, 64, True, 0), "float32", "ffma"),
    ((1, 48, 8, 256, 256, 128, True, 0), "bfloat16", "wgmma"),        # nemotron, GQA 6:1
    ((1, 48, 8, 256, 256, 128, True, 0), "float32", "ffma"),
    ((1, 32, 4, 256, 256, 128, True, 0), "bfloat16", "wgmma"),        # yi, GQA 8:1
    ((1, 32, 4, 256, 256, 128, True, 0), "float32", "ffma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,dt,design", ZOO_ATT_CASES, ids=lambda c: (
    "b{}h{}k{}q{}s{}d{}{}w{}".format(c[0], c[1], c[2], c[3], c[4], c[5], "c" if c[6] else "",
                                     c[7]) if isinstance(c, tuple) else str(c)))
def test_cuda_flash_zoo_shapes_match_plain_version(case, dt, design, cuda):
    """The model zoo's attention shapes: hymba's GQA 5:1 at head dim 64
    with a window of 1024 that binds past 1024 keys (wgmma in bf16, ffma
    in float32), paligemma's MQA 8:1 at head dim 256, minicpm's 36 heads
    of 64 and the KV head of a group of 6 (nemotron) and of 8 (yi, qwen1.5)
    (wgmma in bf16, ffma in float32)."""
    _check_flash(case, dt, design, cuda)


@pytest.mark.gpu
def test_nemotron_full_width_serves_with_a_bit_equal_decode_graph(cuda):
    """nemotron-4-15b at full width, 2 of its 32 layers, bf16 (GQA 6:1, the
    squared-ReLU FFN not gated, 256,000 words): ``serve()`` takes its
    prefill's flash launches in the wgmma design and replays its decode
    graph; ``decode_loop`` graphed and eager from one prefill's caches
    give equal tokens and bit-equal logits at every step."""
    cfg = dataclasses.replace(get_config("nemotron-4-15b"), n_layers=2)
    params = tf.init_params(cfg, seed=31, device=cuda)
    prompts = np.random.default_rng(31).integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)
    ops.reset_launch_counts()
    gen, stats = port_serve.serve(cfg, prompts, max_new=6, params=params, device="cuda")
    assert stats["graph"] is True and gen.shape == (2, 6)
    assert ops.design_counts()["flash_attention"]["wgmma"] == ops.launch_counts()[
        "flash_attention"] == 2
    _graphed_against_eager(cfg, params, prompts, 8, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m", "paligemma-3b"])
def test_reduced_zoo_serve_on_card_equals_cpu(arch, cuda):
    """Reduced hymba, xlstm and paligemma in float32: prefill logits
    (paligemma with prefix embeddings) within 1e-4 of max|logit|, and
    greedy generations of ``serve()`` equal, card against CPU; hymba's
    prompt runs past its window."""
    from repro_torch.launch import steps

    cfg = reduced(get_config(arch))
    params = tf.init_params(cfg, seed=2, device="cpu")
    gpu_params = _to(params, cuda)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
    batch = {"tokens": prompts}
    if cfg.prefix_len:
        batch["prefix_embeds"] = rng.normal(size=(2, cfg.prefix_len, cfg.d_model)).astype(
            np.float32)
    with torch.inference_mode():
        want, _ = steps.make_prefill_step(cfg)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
        got, _ = steps.make_prefill_step(cfg)(
            gpu_params, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * scale)
    g_gpu, _ = port_serve.serve(cfg, prompts, max_new=5, params=gpu_params, device="cuda")
    g_cpu, _ = port_serve.serve(cfg, prompts, max_new=5, params=params, device="cpu")
    np.testing.assert_array_equal(g_gpu, g_cpu)



def _peak_of_call(run, feeds) -> tuple:
    """``run(feeds)``'s outputs, and the allocator's peak over the call less
    what was allocated before it that is not one of ``feeds``: what the
    memory pass counts (the feeds, what the call adds to them)."""
    feed_bytes = sum(t.nbytes for t in feeds.values())
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run(feeds)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - (before - feed_bytes)


@pytest.mark.gpu
def test_donated_executor_call_peak_equals_memory_pass(cuda):
    """``compile(donate=True)``: llama-7b's prefill graph at full width
    (b=1, s=128, float32) through the explicit-collective executor on the
    one-card mesh.  A warmed donated call's allocator peak equals the
    memory pass's per-device peak with that donation set (within 1e-3), as
    the undonated call's equals the pass without it; the logits are the
    undonated call's bit for bit, every feed raises afterwards, and the
    donation lowers the peak."""
    from repro_torch.analysis import analyze_compiled
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engine import DonatedTensor
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    cfg = get_config("llama-7b")
    prog = program_for(cfg, ShapeConfig("donate", "prefill", 128, 1))
    mesh = Mesh({"data": 1, "model": 1}, device=cuda)

    def feeds(seed=3):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return {n.name: (torch.randint(0, cfg.vocab, n.shape, generator=gen, device=cuda,
                                       dtype=torch.int32)
                         if str(np.dtype(n.dtype)) == "int32"
                         else torch.randn(n.shape, generator=gen, device=cuda) * 0.02)
                for n in prog.graph.nodes if n.kind == "input"}

    peaks, outs = {}, {}
    for donate in (False, True):
        # the allocator hands out a whole cached block where the rest of it
        # would be small, so what earlier tests left cached would count
        gc.collect()
        torch.cuda.empty_cache()
        run = prog.compile(mesh=mesh, executor="shard_map", donate=donate)
        static = analyze_compiled(run).memory["peak_bytes"]
        with torch.inference_mode():
            run(feeds())  # warm-up
            torch.cuda.synchronize()
            fed = feeds()
            outs[donate], measured = _peak_of_call(run, fed)
        assert abs(static / measured - 1.0) <= 1e-3, (donate, static, measured)
        assert all((type(t) is DonatedTensor) == donate for t in fed.values())
        peaks[donate] = measured
        del run, fed
        torch.cuda.empty_cache()
    assert torch.equal(outs[True]["logits"], outs[False]["logits"])
    assert peaks[True] < peaks[False], peaks


# ---------------------------------------------------------------------------
# the compiled decode step: one CUDA graph replayed per step
# ---------------------------------------------------------------------------

def _logit_tap(decode, logs, prompt_len: int):
    """``decode`` that also writes each step's last-position logits into
    row ``pos - prompt_len`` of ``logs`` (steps, b, v) float32 on the card,
    indexed by the position tensor: a replayed graph writes every step's
    row, as the eager step does."""
    def tapped(params, tokens, caches, pos):
        logits, caches = decode(params, tokens, caches, pos)
        logs.index_copy_(0, (pos - prompt_len).view(1), logits[:, -1].float()[None])
        return logits, caches

    return tapped


def _graphed_against_eager(cfg, params, prompts, max_new: int, cuda) -> dict:
    """``decode_loop`` from two copies of one prefill's caches, ``max_new -
    1`` decode steps captured and replayed (``graph=True``: a failed
    capture fails the test) and as many eager: the tokens and every step's
    logits equal, and so are the launches by design (the replays' counted
    from the capture's), which it returns."""
    from repro_torch.core import tree
    from repro_torch.launch import steps

    b, s = prompts.shape
    with torch.inference_mode():
        logits, caches = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.as_tensor(prompts, device=cuda)})
        caches = port_serve.prepare_decode_caches(cfg, caches, s, s + max_new)
        copy = tree.map(torch.clone, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        got = {}
        for graph, cs in ((True, caches), (False, copy)):
            logs = torch.full((max_new - 1, b, logits.shape[-1]), float("nan"), device=cuda)
            ops.reset_launch_counts()
            gen, _, n = port_serve.decode_loop(
                _logit_tap(steps.make_serve_step(cfg), logs, s), params, cs, tok, s,
                max_new, graph=graph)
            torch.cuda.synchronize()
            got[graph] = (gen, logs.cpu(), ops.design_counts())
    (g_gen, g_log, g_designs), (e_gen, e_log, e_designs) = got[True], got[False]
    diff = float((g_log - e_log).abs().max())
    print(f"{cfg.name} {cfg.dtype}: graphed against eager, max|logit diff| = {diff:.3e}")
    np.testing.assert_array_equal(g_gen, e_gen)
    assert diff == 0.0
    assert g_designs == e_designs
    return g_designs


GRAPH_CASES = [("llama-7b", "float32"), ("qwen2-moe-a2.7b", "float32"),
               ("qwen2-moe-a2.7b", "bfloat16"), ("hymba-1.5b", "float32"),
               ("xlstm-125m", "float32"), ("paligemma-3b", "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dt", GRAPH_CASES)
def test_graphed_decode_equals_eager_decode_on_card(arch, dt, cuda):
    """Reduced configs (qwen2-moe in bf16 too: its gmm launches take the
    wgmma design inside the graph): ``decode_loop`` from two copies of one
    prefill's caches, 9 decode steps captured and replayed
    (``graph=True``: a failed capture fails the test) and 9 eager.  The
    tokens and every step's logits are equal, and so are the launches by
    design (the replays' counted from the capture's); hymba's prompt of 20
    decodes past its window of 16."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dt)
    params = tf.init_params(cfg, seed=4, device=cuda)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 20)).astype(np.int32)
    max_new = 10
    g_designs = _graphed_against_eager(cfg, params, prompts, max_new, cuda)
    per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    assert sum(g_designs["gmm"].values()) == per_layer * cfg.n_layers * (max_new - 1)
    if cfg.moe and dt == "bfloat16":
        assert g_designs["gmm"]["wgmma"] == per_layer * cfg.n_layers * (max_new - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-7b", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m"])
def test_graphed_engine_equals_eager_engine_on_card(arch, cuda):
    """The engine's default step on a card (a graph captured at its second
    decode step) against ``graph=False``: three requests through two slots,
    the same weights; generations and launches by design equal."""
    from repro_torch.serving import ServingEngine

    cfg = reduced(get_config(arch))
    params = tf.init_params(cfg, seed=6, device=cuda)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in (21, 9, 30)]
    out = {}
    for graph in (None, False):
        eng = ServingEngine(cfg, batch=2, max_seq=40, block=8, params=params, device=cuda,
                            graph=graph)
        for p, n in zip(prompts, (6, 9, 5)):
            eng.submit(p, n)
        ops.reset_launch_counts()
        res, m = eng.run()
        out[graph] = (res, ops.design_counts(), m.decode_steps)
        assert eng.graph is (graph is None)
        if graph is None:
            assert eng._step.replays == m.decode_steps - 1
    (g_res, g_designs, g_steps), (e_res, e_designs, e_steps) = out[None], out[False]
    assert g_steps == e_steps and sorted(g_res) == sorted(e_res) == [0, 1, 2]
    for rid in e_res:
        np.testing.assert_array_equal(g_res[rid], e_res[rid])
    assert g_designs == e_designs


PREFILL_ARCHS = ("llama-7b", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m", "paligemma-3b")


def _live_leaves(caches) -> list:
    """Every leaf of an engine's caches, each KV pool without its scratch
    block 0 (the 0-padded table entries' writes land there, in no set
    order, and nothing reads them)."""
    from repro_torch.models.attention import PagedKVCache

    out = []

    def walk(c):
        if isinstance(c, PagedKVCache):
            out.extend((c.k[:, 1:], c.v[:, 1:]))
        elif isinstance(c, torch.Tensor):
            out.append(c)
        else:
            for x in c:
                walk(x)

    walk(caches)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_graphed_bucket_prefills_equal_eager_on_card(arch, cuda):
    """The engine's bucket prefill with its admission, graphed (a bucket's
    step eager at its first use, captured at its second, replayed after;
    all buckets' graphs in one pool) against ``graph=False``, from the
    same weights: five admissions whose two buckets alternate (13 tokens
    into slot 0, 5 into slot 1, ...).  After every admission the first
    token, the seeded token buffer, every pool block but the scratch block
    and every state leaf bit-equal."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import Request

    cfg = reduced(get_config(arch))
    params = tf.init_params(cfg, seed=4, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for n in (13, 5, 13, 5, 13)]
    engines = {g: ServingEngine(cfg, batch=2, max_seq=32, block=8, params=params,
                                device=cuda, graph=g) for g in (None, False)}
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            slot = i % 2
            got = {}
            for g, eng in engines.items():
                req = Request(rid=i, prompt=p, max_new=4)
                eng._prefill_into(req, slot, [1 + 3 * slot, 2 + 3 * slot, 3 + 3 * slot])
                got[g] = (req.first_tok, eng.tokens.clone(),
                          [t.clone() for t in _live_leaves(eng.caches)])
            (g_tok, g_buf, g_leaves), (e_tok, e_buf, e_leaves) = got[None], got[False]
            assert g_tok == e_tok and torch.equal(g_buf, e_buf), (arch, i)
            for a, b in zip(g_leaves, e_leaves):
                assert torch.equal(a, b), (arch, i)
    graphed = engines[None]
    runs = list(graphed._prefills.values())
    assert len(runs) == 2 and sorted(r.replays for r in runs) == [1, 2], arch
    assert graphed._pool is not None and all(r.pool is graphed._pool for r in runs)
    assert all(r._graph is not None for r in runs)
    assert all(r.replays == 0 for r in engines[False]._prefills.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_bucket_captured_at_its_first_use_after_another_bucket_warmed(arch, cuda):
    """Whether a bucket's step could be captured at its first use once the
    process has run another bucket's (kernels built, library handles
    made), as a measurement: bucket A (13 tokens) run eagerly and then
    captured, then bucket B (5 tokens) captured at its first call (its
    fixed outputs made beforehand, so the step skips its eager call) and
    replayed at its second; every admission bit-equal to an eager
    engine's.  The engine keeps its rule (capture at the second use)."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import Request

    cfg = reduced(get_config(arch))
    params = tf.init_params(cfg, seed=5, device=cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in (13, 13, 5, 5)]
    engines = {g: ServingEngine(cfg, batch=2, max_seq=32, block=8, params=params,
                                device=cuda, graph=g) for g in (None, False)}
    graphed = engines[None]
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            if i == 2:  # bucket B's step made now, its outputs given: no eager call
                first_use = graphed._compiled_prefill(graphed.registry.prefill(len(p)))
                first_use.outputs = (torch.zeros((1,), dtype=torch.int32, device=cuda),
                                     torch.zeros((2, 1), dtype=torch.int32, device=cuda))
            got = {}
            for g, eng in engines.items():
                req = Request(rid=i, prompt=p, max_new=4)
                eng._prefill_into(req, i % 2, [1 + 3 * (i % 2), 2 + 3 * (i % 2),
                                               3 + 3 * (i % 2)])
                got[g] = (req.first_tok, eng.tokens.clone(),
                          [t.clone() for t in _live_leaves(eng.caches)])
            (g_tok, g_buf, g_leaves), (e_tok, e_buf, e_leaves) = got[None], got[False]
            assert g_tok == e_tok and torch.equal(g_buf, e_buf), (arch, i)
            for a, b in zip(g_leaves, e_leaves):
                assert torch.equal(a, b), (arch, i)
    assert first_use._graph is not None and first_use.replays == 2


_FAILED_CAPTURE = r"""
import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as tf
from repro_torch.serving import ServingEngine

cfg = reduced(get_config("llama-7b"))
eng = ServingEngine(cfg, batch=1, max_seq=32, block=8, device="cuda",
                    params=tf.init_params(cfg, seed=0, device="cuda"))
reads, get = [], eng.registry.prefill


def prefill(n, batch=1):
    ent = get(n, batch)
    base = getattr(ent, "plain", ent.step)
    ent.plain = base

    def step(params, batch, last_index):
        logits, caches = base(params, batch, last_index)
        reads.append(float(logits.float().abs().max()))  # a host read
        return logits, caches

    ent.step = step
    return ent


eng.registry.prefill = prefill
for n in (5, 6, 7):  # one bucket: the second admission captures
    eng.submit(np.arange(1, n + 1, dtype=np.int32), 3)
try:
    eng.run()
except RuntimeError:
    (run,) = eng._prefills.values()
    print("raised", run._graph is None, run.replays, len(reads), eng.metrics.prefills)
else:
    print("ran")
"""


@pytest.mark.gpu
def test_failed_capture_raises_and_never_falls_back(cuda):
    """A bucket prefill that reads the host cannot be captured: its second
    use raises out of ``run()``, no graph is kept, nothing replays, and
    the step did not run eagerly instead (one prefill served, its host
    read made once).  In a process of its own: the failed capture leaves
    its stream's capture invalidated."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], capture_output=True,
                         text=True, timeout=600, cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split()[-5:] == ["raised", "True", "0", "1", "1"], out.stdout


@pytest.mark.gpu
def test_graphed_train_step_equals_eager_within_their_spread(cuda):
    """``train()`` on reduced llama (float32, b=2, s=32, 4 steps) with its
    step as a CUDA graph and twice eagerly (``graph=False``), the same
    seed: the graph's losses and final parameters no farther from the
    first eager run's than the second eager run is (bit-equal where the
    eager runs are); the step counter 4, three replays."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.launch import train as train_mod

    cfg = reduced(get_config("llama-7b"))
    shape = ShapeConfig("t", "train", 32, 2)
    runs = [train_mod.train(cfg, shape, steps_total=4, device=cuda, log_every=4, graph=g)
            for g in (None, False, False)]
    assert [r["replays"] for r in runs] == [3, 0, 0]
    assert all(int(r["opt_state"].step) == 4 for r in runs)

    def dist(a, b):
        return max(float((torch.as_tensor(x).float() - torch.as_tensor(y).float()).abs().max())
                   for x, y in zip(a, b))

    losses = [[s["loss"] for s in r["steps"]] for r in runs]
    params = [tree.leaves(r["params"]) for r in runs]
    print(f"graph - eager: losses {dist(losses[0], losses[1]):.3e}, parameters "
          f"{dist(params[0], params[1]):.3e}; eager - eager: {dist(losses[2], losses[1]):.3e}, "
          f"{dist(params[2], params[1]):.3e}")
    assert dist(losses[0], losses[1]) <= dist(losses[2], losses[1])
    assert dist(params[0], params[1]) <= dist(params[2], params[1])
