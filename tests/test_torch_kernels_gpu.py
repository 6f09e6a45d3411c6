"""On a card: the CUDA flash-attention kernel against its plain torch
version, and the reduced serving path on the card against the CPU.

Imports torch and the port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (inside the test, so every worker collects
the same tests).  Tolerances are the reference kernel tests' own: 2e-5 in
float32, 2e-2 in bfloat16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
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
