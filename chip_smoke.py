"""Drive the PyTorch/CUDA port on one card and check it, phase by phase.

    python3 chip_smoke.py

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from the sources in this checkout, with
   nvcc's ``-Xptxas -v`` report (registers, shared memory, spills);
3. kernel parity: each kernel against its plain torch version on the card,
   at the reference kernel tests' shapes and tolerances (float32 2e-5,
   bfloat16 2e-2), ragged lengths, GQA and the serving path's shape;
4. kernel timing at the serving path's shape (CUDA events): the kernel,
   its plain version, one library call for the same function, the bound;
5. serve llama-7b at full width and depth (bf16, batch 4, prompt 512, 16
   new tokens) through ``repro_torch.launch.serve.serve``, planned through
   a plan-cache file (the serve call's plan is a cache hit), with launch
   counters set to 0 just before and read just after; then one prefill and
   one decode step under torch.profiler (device busy time, idle share,
   device time by kernel kind);
6. slice parity: full width, 2 layers, float32, the same weights on the
   card (kernel path) and on the CPU (plain path).

Any failure raises and exits non-zero before the last line.  The last
three lines are the ``nvidia-smi`` name and power limit, a JSON line of
kernel numbers and ``{"ok": true, "device": {...}}``.  All numbers also go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate and
# the bf16 tensor-core rate; float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (b, hq, hkv, sq, sk, d, causal, window, dtype)
ATT_CASES = [  # tests/test_kernels.py
    (1, 4, 2, 128, 128, 64, True, 0, torch.float32),
    (2, 2, 1, 256, 256, 32, True, 64, torch.float32),
    (1, 2, 2, 128, 256, 64, False, 0, torch.float32),
    (1, 8, 1, 128, 128, 128, True, 0, torch.float32),
    (1, 4, 4, 128, 128, 64, True, 0, torch.bfloat16),
    (2, 4, 2, 64, 64, 16, True, 32, torch.float32),
]
EXTRA_CASES = [
    (1, 4, 4, 200, 200, 128, True, 0, torch.float32),     # ragged
    (1, 4, 4, 200, 200, 128, True, 0, torch.bfloat16),    # ragged, bf16
    (2, 16, 4, 300, 300, 128, True, 0, torch.bfloat16),   # GQA 4:1, ragged
    (1, 8, 2, 77, 333, 256, False, 0, torch.float32),     # d = 256, GQA
    (1, 4, 1, 90, 90, 64, True, 40, torch.float32),       # window, GQA
]
SLICE = (4, 32, 32, 512, 512, 128, True, 0, torch.bfloat16)  # llama-7b prefill
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _inputs(case, seed=0, device="cuda"):
    b, hq, hkv, sq, sk, d, causal, window, dt = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(device=device, dtype=dt)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, q_offset=sk - sq if causal else 0)
    return q, k, v, kw


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_bound_ms(case, ref_mod) -> tuple[float, str, int, int]:
    """Least time for the function on this card: bytes (each input read
    once, the output written once) over the memory rate vs the operations
    these inputs need (two products over the unmasked (q, k) pairs) over
    the peak rate of their type."""
    b, hq, hkv, sq, sk, d, causal, window, dt = case
    item = torch.tensor([], dtype=dt).element_size()
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * item
    pairs = int(ref_mod._mask(sq, sk, sk - sq if causal else 0, 0, causal,
                              window).sum())
    ops = 4 * b * hq * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plancache import PlanCache
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.eingraphs import program_for

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    results: dict = {}

    # 1. device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", f"{kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
                  f"cuda {torch.version.cuda}")
    results["device"] = {"kind": kind, "count": count, "nvidia_smi": smi}

    # 2. build ----------------------------------------------------------------
    built = fa.build_info()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "ptxas info" in ln or "spill" in ln]
    log("build", f"flash_attention.cu in {built.build_s:.1f} s -> {built.path.name}")
    for ln in ptxas:
        log("build", ln)
    results["build"] = {"flash_attention_s": built.build_s, "ptxas": ptxas}

    # 3. kernel parity ----------------------------------------------------------
    parity = []
    for case in ATT_CASES + EXTRA_CASES + [SLICE]:
        q, k, v, kw = _inputs(case)
        got = ops.flash_attention(q, k, v, impl="kernel", **kw)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = TOL[case[-1]]
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        parity.append({"case": str(case), "max_abs_err": float(err.max()), "ok": ok})
        log("parity", f"{case}: max|kernel - plain| = {float(err.max()):.3e} "
                      f"(tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees at {case}")
    results["parity"] = parity
    slice_err = parity[-1]["max_abs_err"]

    # 4. kernel timing at the serving path's shape ----------------------------------
    q, k, v, kw = _inputs(SLICE, seed=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_kernel = _time_ms(lambda: ops.flash_attention(q, k, v, impl="kernel", **kw), 20)
    t_plain = _time_ms(lambda: ref.attention(q, k, v, **kw), 5)
    t_lib = _time_ms(lambda: sdpa(q, k, v, is_causal=True), 20)
    bound_ms, bound_by, nbytes, nops = _attention_bound_ms(SLICE, ref)
    log("timing", f"flash_attention {SLICE[:6]} bf16 causal: kernel {t_kernel:.4f} ms, "
                  f"plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes} B, {nops} ops)")
    results["timing"] = {"kernel_ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": nbytes, "ops": nops}
    del q, k, v

    # 5. serve llama-7b, full width and depth --------------------------------------
    cfg = get_config("llama-7b")
    b, prompt_len, max_new = 4, 512, 16
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(b, prompt_len)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        cold = PlanCache.open(store)
        t0 = time.perf_counter()
        program_for(cfg, ShapeConfig("serve", "prefill", prompt_len, b)).compile(
            mesh_axes=dict(serve_mod.ONE_DEVICE_MESH), cache=cold)
        t_cold = time.perf_counter() - t0
        assert cold.stats["misses"] == 1 and cold.stats["hits"] == 0, cold.stats
        t0 = time.perf_counter()
        params = tf.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        log("serve", f"planned cold in {t_cold:.4f} s; {n_params} params made on the "
                     f"card in {t_init:.1f} s")
        # a short warm-up request, then the counted run
        serve_mod.serve(cfg, prompts, max_new=2, params=params,
                        plan_cache=PlanCache.open(store), device="cuda")
        warm = PlanCache.open(store)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        gen, stats = serve_mod.serve(cfg, prompts, max_new=max_new, params=params,
                                     plan_cache=warm, device="cuda")
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    assert warm.stats["hits"] == 1 and warm.stats["misses"] == 0, warm.stats
    assert launches["flash_attention"] == cfg.n_layers, launches
    assert gen.shape == (b, max_new), gen.shape
    assert ((gen >= 0) & (gen < cfg.vocab_padded)).all()
    # where the time goes: one prefill and one decode step under the profiler
    prefill, decode = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device="cuda")
        logits, caches = prefill(params, {"tokens": tokens})
        assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
        caches = serve_mod.prepare_decode_caches(cfg, caches, prompt_len,
                                                 prompt_len + max_new)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        breakdown = {
            "prefill": _profile(lambda: prefill(params, {"tokens": tokens})),
            "decode_step": _profile(lambda: decode(params, tok, caches, prompt_len)),
        }
    for name, br in breakdown.items():
        log("profile", f"{name}: wall {br['wall_ms']:.3f} ms, device busy "
                       f"{br['device_ms']:.3f} ms (idle share {br['idle_share']:.3f}), "
                       f"{br['kernels']} kernels; device ms by kind {br['by_kind_ms']}; "
                       f"top {br['top_kernels_ms'][:3]}")
    del caches
    log("serve", f"llama-7b bf16 b={b} prompt={prompt_len} new={max_new}: "
                 f"t_plan_s={stats['t_plan_s']:.4f} (cache hit) "
                 f"t_prefill_s={stats['t_prefill_s']:.4f} "
                 f"t_decode_s={stats['t_decode_s']:.4f} tok_per_s={stats['tok_per_s']:.2f} "
                 f"max_memory_allocated={peak} launches={launches}")
    log("serve", f"generations[0] = {gen[0].tolist()}")
    results["serve"] = {k: v for k, v in stats.items() if k != "policy"}
    results["serve"].update({"t_plan_cold_s": t_cold, "max_memory_allocated": peak,
                             "launches": launches, "n_params": n_params,
                             "batch": b, "prompt_len": prompt_len, "max_new": max_new,
                             "profile": breakdown})
    del params, logits
    torch.cuda.empty_cache()

    # 6. slice parity: the card (kernel) against the CPU (plain path) ------------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = tf.init_params(cfg2, seed=1, device="cpu")
    gpu_params = _map(cpu_params, lambda t: t.to("cuda"))
    p2 = np.random.default_rng(1).integers(0, cfg2.vocab, size=(2, 64)).astype(np.int32)
    prefill = steps.make_prefill_step(cfg2)
    ops.reset_launch_counts()
    with torch.inference_mode():
        lg_gpu, _ = prefill(gpu_params, {"tokens": torch.as_tensor(p2, device="cuda")})
        lg_cpu, _ = prefill(cpu_params, {"tokens": torch.as_tensor(p2)})
    assert ops.launch_counts()["flash_attention"] == 2
    lg_gpu, lg_cpu = lg_gpu.float().cpu(), lg_cpu.float()
    scale = float(lg_cpu.abs().max())
    diff = float((lg_gpu - lg_cpu).abs().max())
    # float32 end to end with TF32 off: the card and the CPU differ only in
    # the order of their sums (4096- and 11008-wide contractions)
    torch.testing.assert_close(lg_gpu, lg_cpu, rtol=1e-4, atol=1e-4 * scale)
    g_gpu, _ = serve_mod.serve(cfg2, p2, max_new=4, params=gpu_params, device="cuda")
    g_cpu, _ = serve_mod.serve(cfg2, p2, max_new=4, params=cpu_params, device="cpu")
    assert np.array_equal(g_gpu, g_cpu), (g_gpu, g_cpu)
    log("slice-parity", f"llama-7b width, 2 layers, f32: max|logit diff| = {diff:.3e} "
                        f"(max|logit| {scale:.3f}); greedy tokens equal: {g_gpu.tolist()}")
    results["slice_parity"] = {"max_abs_logit_diff": diff, "max_abs_logit": scale,
                               "tokens": g_gpu.tolist()}

    kernels = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:134",
        "launches": launches["flash_attention"], "max_abs_err": slice_err,
        "ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": t_lib}]}
    results.update(kernels)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))

    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


def _profile(fn) -> dict:
    """``fn`` warmed up, timed once on the host clock (ending in a
    synchronize), then run once more under torch.profiler: the device time
    of its kernels, by kind (this port's flash-attention kernel, cuBLAS
    matrix products, everything else), and the idle share of the
    unprofiled wall time (tracing itself slows the host down)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kind = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "Loading" in e.name or "Buffer" in e.name:
            continue
        n += 1
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        kind = ("flash_attention" if "flash_fwd_kernel" in name else
                "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet"))
                else "other")
        by_kind[kind] += ms
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    device_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kernels": n,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "by_kind_ms": {k: round(v, 4) for k, v in by_kind.items()},
            "top_kernels_ms": [(k, round(v, 4)) for k, v in top]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
