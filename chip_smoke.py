"""Drive the PyTorch/CUDA port on one card and check it, phase by phase.

    python3 chip_smoke.py

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels (flash attention with its ring step; matmul
   with its grouped twin ``gmm``) from the sources in this checkout, one
   nvcc per source, all started together, with nvcc's ``-Xptxas -v``
   report (registers, shared memory, spills) and a summary of the wgmma
   and ffma kernels' registers, spills and dynamic shared memory (every
   one of them, the forward's wgmma and ffma kernels at head dim 256
   included, with 0 spill bytes);
3. kernel parity: the forward kernel against its plain torch version on
   the card, at the reference kernel tests' shapes and tolerances (float32
   2e-5, bfloat16 2e-2), ragged lengths, GQA, windows, cross attention,
   q offsets and the serving path's shape, each case with the design that
   served it (the wgmma design for bf16 and the ffma design for float32,
   each at head dim 64, 128 and 256; the template for the rest), a
   float32 (b, s, h, d) view (ffma) and a float32 base 4 bytes off 16
   (the template), and rows that see no key against the TPU kernel's tile
   convention (``ref.attention_tiled``) in all three designs;
4. kernel timing at the serving path's shape (CUDA events, and the
   kernel's device time from torch.profiler): the kernel, the template
   design at the same inputs (its C entry called directly), its plain
   version, one library call for the same function, the bound; then in
   float32 at the same shape (the executor call's: the ffma design, the
   template's device time beside it, SDPA in float32 by device time);
5. serve llama-7b at full width and depth (bf16, batch 4, prompt 512, 16
   new tokens) through ``repro_torch.launch.serve.serve``, planned through
   a plan-cache file (the serve call's plan is a cache hit), with launch
   counters set to 0 just before and read just after, every launch of the
   wgmma design; then one prefill and one decode step under torch.profiler
   (device busy time, idle share, device time by kernel kind);
6. slice parity: full width, 2 layers, float32, the same weights on the
   card (kernel path) and on the CPU (plain path);
7. matmul parity: the kernel against its plain version at the reference
   tests' shapes, ragged shapes, strided views (both majors of each
   operand) and every product shape of llama-7b's prefill graph (b=4,
   s=512), float32 (1e-4) and bf16 (3e-2, atol x8), each case with its
   design (float32 takes the ffma design where the rule allows, else the
   template; both are held to the plain version);
8. ring-step parity: the step kernel chained over r = 2 and 4 kv blocks
   from every ring position, causal, windowed and GQA (float32 2e-5,
   bf16 2e-2), each carry against the plain step and the finalised chain
   against the forward kernel, at the serving shape cut 4 ways too in
   bf16 and in float32, each case with its design (head dim 64 and 128:
   bf16 wgmma, float32 ffma; d = 16 and 32 the template; the step's wgmma
   design stops at 128);
9. timing (CUDA events; device time from torch.profiler where the host
   would bound a short kernel): matmul at every distinct product shape of
   llama-7b's prefill graph in float32 (the ffma design, the template
   beside it) and in bf16 (the wgmma design, the template beside it), the
   ring step at the serving shape cut 4 ways in bf16 (the wgmma design)
   and in float32 (the ffma design), each with the template beside it,
   each beside its plain version, its library call (none for the step)
   and its bound;
10. executor path: llama-7b's prefill graph at full width (embed, one
   block period, lm_head) planned through a plan-cache file on a 1x1 mesh
   (cold, then a hit), run with ``executor="shard_map"`` in float32 and in
   bf16 with the launch counters set to 0 just before each call and read
   just after (every clean contraction through the matmul kernel, one
   flash-attention launch; in bf16 every launch of the wgmma design, in
   float32 every launch of the ffma design), its logits held
   against the dense ``executor="gspmd"`` run on the card, then profiled;
11. ring path: the same graph on 4 gloo ranks that share the card (blocks
   staged through the host), sequence-parallel (every ``s`` label on the
   ``seq`` axis), in float32 and then in bf16: attention rides the ring
   through the step kernel (float32: every step and every matmul of the
   ffma design; bf16: every step launch of the wgmma design); counters per rank,
   logits against the one-card dense run of the same dtype;
12. gmm parity: the grouped-matmul kernel against ``ref.gmm`` at the
   reference tests' shapes, ragged shapes, expert-strided views, and
   qwen2-moe's prefill and decode and mixtral's expert shapes, float32
   (1e-4, atol x8) and bf16 (3e-2, atol x8), each case with its design;
13. gmm timing (CUDA events) in bf16 at qwen2-moe's w1 and w2 prefill
   shapes, its decode shape and mixtral's, and in float32 at qwen2-moe's
   w1: kernel, template design, plain version, ``torch.bmm`` and the
   bound;
14. serve qwen2-moe-a2.7b at full width and depth (bf16, batch 4, prompt
   512, 16 new tokens, 60 experts padded to 64, top-4, shared expert),
   planned through a plan-cache file, counters set to 0 just before the
   serve call and read just after (24 flash launches, 72 gmm launches per
   prefill and per decode step, all of the wgmma design), then profiled;
15. MoE slice parity: qwen2-moe width, 2 layers, float32, the same
   weights on the card (gmm kernel, its launches by design) and on the
   CPU (plain path);
16. a2a path: qwen2-moe's prefill graph (one block period) with the MoE
   stubs on 4 gloo ranks sharing the card, the expert label on a 4-way
   axis, so dispatch and combine run the ``a2a`` rule's all_to_all
   program; the collectives each rank issued against the static trace,
   the logits against the one-card dense run;
17. train parity: llama-7b at full width, 2 layers, float32, batch 1,
   seq 128, the same weights and batch on the card (the flash kernel's
   ffma design inside its autograd Function, whose backward is the
   plain version's) and on the CPU (the plain path): the loss and every
   gradient leaf of ``loss_fn`` (1e-4 relative; 1e-4 x max|g| a leaf),
   then one ``make_train_step`` on each side (loss and grad norm, 1e-4
   relative), 2 layers x 2 flash launches each (forward and remat
   recompute);
18. train llama-7b at full width (bf16) with 8 of its 32 layers (the
   parameters, gradients and f32 AdamW moments of all 32 would fill the
   card), batch 4, seq 512, cosine schedule, 8 steps through
   ``repro_torch.launch.train.train`` with a plan-cache file and a
   checkpoint directory under ``chiprun_out/``: per-step loss, grad norm
   and wall time, peak memory, flash launches per step (all wgmma), a
   finite and falling loss, the checkpoint restored through
   ``CheckpointManager.restore_latest`` bit-equal to the state in memory;
   then one warmed step under torch.profiler (device busy time, idle
   share, device time by kind, inside the plain attention backward and
   inside the optimizer);
19. the paper's Experiment 2 at AmazonCat-14K sizes (597,540 features,
   8,192 hidden, 14,588 labels, batch 512, float32): the FFNN graph built
   here with the port's ``EinGraph``, ``Program.grad(wrt=["W1", "W2"])``
   compiled with ``executor="shard_map"`` on the 1x1 mesh through a
   plan-cache file (cold, then a hit), 3 SGD steps with every matmul
   launch of the ffma design, the first step's gradients against
   ``torch.autograd`` of the plain FFNN on the card (1e-4 x max|g|), the
   step's wall and device time against its FLOP bound;
20. the serving tier: llama-7b at full width and depth (bf16, seed-0
   weights) through ``repro_torch.serving.ServingEngine``: 4 slots,
   blocks of 16, max_seq 528, 8 requests with prompt lengths from seed 0
   in 192..512 (both pow2 buckets, 256 and 512), 16 new tokens each; a
   first engine over a new plan-cache file, a second over the same file
   (hits only; its run gives the timings); launch counters set to 0 just
   before each run and read just after (32 flash launches a prefill, all
   wgmma); registry compiles = buckets + 1; a third run copies out the
   logits behind every token, and each request is held against the serve
   loop's run of it alone, teacher-forced on the engine's tokens: logits
   within 5e-2 of max|logit| at every position, the engine's token the
   sequential argmax except where the top-2 gap is under twice the two
   runs' measured logit difference (near ties under 2e-2 of max|logit|
   and flips printed), the 5e-2 limit shown to tell another request's
   context apart; TTFT per request, tok/s, occupancy, peak memory and
   pool bytes; one engine decode step with every slot live profiled
   beside phase 5's;
21. the same for qwen2-moe-a2.7b: 2 slots, exact-length buckets 384, 448
   and 512, 8 new tokens; 72 gmm launches per prefill and per decode step,
   all wgmma; each request compared up to the first position where a MoE
   layer sent its token to other experts than the run alone did (a bf16
   routing near tie, printed with the layer); profiled beside phase 14's
   decode step;
22. engine parity: llama-7b width and qwen2-moe width, 2 layers, float32,
   3 requests through 2 slots on the card and on the CPU (every flash and
   gmm launch of the ffma design); tokens equal, every decode step's
   logits within 1e-4 of max|logit|;
23. the model zoo's flash shapes: hymba-1.5b's prefill (4, 25, 2048, 64)
   with GQA 5:1 and a window of 1024 that binds and paligemma-3b's (4, 8,
   512, 256) with MQA 8:1, both bf16 (the wgmma design; at head dim 256
   its 64-key tiles), paligemma's float32 slice (1, 8, 320, 256) of
   phase 27 and its prefill shape (4, 8, 512, 256) in float32 (the ffma
   design, 32-row q tiles at head dim 256), each against its plain
   version, its device time beside SDPA's on the same function in the
   same type (``enable_gqa``; hymba's window as a mask; SDPA's kernels
   printed to name its backend), the template's and the bound;
24-26. serve hymba-1.5b (prompt 2048, so the window binds in prefill and
   decode runs on the ring buffer), xlstm-125m (prompt 512; no flash kernel
   runs) and paligemma-3b (prompt 512 from tokens, as the reference serves
   it; then one ``make_prefill_step`` call on 256 seeded prefix embeddings
   and 256 tokens) at full width and depth, bf16, batch 4, 16 new tokens,
   as phase 5 serves llama-7b (every flash launch wgmma), each prefill and
   decode step profiled;
27. zoo slice parity, float32, full width, 2 layers (xlstm: one mLSTM and
   one sLSTM block), batch 1, the same weights on the card and the CPU:
   logits (1e-4 x max|logit|), ``loss_fn`` (1e-4 relative) and every
   gradient leaf (1e-3 x its max|g|: at hymba's s = 1280 the card's plain
   path, run beside it without the kernel and printed, already differs
   from the CPU by a few 1e-4 of max|g|), all finite; for hymba, the CPU's gradients
   without the window must move every attention leaf by more than that
   limit; hymba at s = 1280 (the window binds; the ffma flash), xlstm at
   s = 512, paligemma with 256 prefix embeddings and 64 tokens (the ffma
   flash at d = 256); then one
   block period of hymba's (b=4, s=2048) and paligemma's (b=4, s=512)
   prefill EinGraph in bf16 through ``executor="shard_map"`` on the
   one-rank mesh against the dense run (the wgmma matmul at d_model 1600,
   kv 320, d_ff 5504 and d_ff 16384, vocab 257,280);
28. the engine on hymba-1.5b at full size (2 slots, 3 requests with prompts
   from seed 28 in 1100..1500, exact buckets, 8 new tokens), held against
   ``serve()`` of each request alone as phase 20, its logit limit twice
   what serving each request in a batch of two does to ``serve()``'s own
   bf16 logits in the same run (hymba amplifies bf16 rounding through its
   32 layers; the limit must still tell another context apart); the same
   engine in float32 at full width and depth, held against ``serve()`` at
   1e-4 x max|logit| with no unexplained token flip; and the engine parity
   of phase 22 for xlstm-125m width.  The kernels line gives every kernel's
   zoo launches by design (``ops.design_counts()`` over phases 24-28);
29. the pipelined path: llama-7b's prefill graph of phase 10 (b=4, s=512)
   compiled with ``pipeline=PipelineSpec(stages=p, microbatches=m)`` on a
   ``{"pp": p}`` mesh of p gloo ranks sharing the card (handoffs staged
   through the host), (p, m) = (1, 1) on one rank, then (2, 1), (2, 4) and
   (4, 2), each in float32 and bf16: the static schedules against the
   reference's (stages, handoff elems, bubble); on every rank the logits
   bit for bit equal to the unpipelined compile of the stitched plan on the
   same mesh, m x (8 matmul, 1 flash) launches, all ffma in float32 and all
   wgmma in bf16, the collectives issued equal to the static trace
   (ppermute over ``pp`` only, none at p = 1); rank 0's logits against the
   dense one-card run to phase 10's limits; the rank walls are host-staged
   gloo, not a speed path;
30. the static verifier on the card: (a) ``python -m repro_torch.analysis``
   over the reduced zoo in a subprocess, clean, with CUDA never initialised
   and no jax in it; (b) the memory pass's per-device peak
   (``analyze_compiled(run).memory["peak_bytes"]``) against the
   allocator's peak of one warmed call (``max_memory_allocated`` less what
   was allocated before the call and is not its feeds), within 10%, for
   phase 10's one-rank llama-7b prefill graph in float32 and in bf16 (its
   float nodes typed bfloat16) and phase 19's FFNN gradient program;
   (c) ``BucketRegistry.analyze()`` of phase 20's engine registry, every
   bucket clean.  The kernels line gives the matmul and flash rows'
   launches on the pipelined path by design (``pipeline_launches``,
   ``pipeline_design``).

Phase 4 also times the forward kernel at one engine prefill, (1, 32, 512,
128) causal, in bf16 (wgmma) and in float32 (ffma), each with the
template's device time beside it, beside SDPA's device time in the same
type.

Every kernel has a design picked by the shape rule in its wrapper before
launch (``"wgmma"`` for bf16 and ``"ffma"`` for float32 operands the rule
takes, ``"template"`` for the rest), and the wrapper counts launches per
design (``ops.design_counts()``); the template is timed beside the other
design by calling its C entry directly, which moves no counter.  Any
failure raises and exits non-zero before the last line.  The last
three lines are the ``nvidia-smi`` name and power limit, a JSON line of
kernel numbers and ``{"ok": true, "device": {...}}``.  All numbers also go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
    (2, 16, 4, 300, 300, 128, True, 64, torch.float32),   # window, GQA 4:1, ragged
    (1, 4, 4, 77, 333, 64, True, 0, torch.float32),       # ragged, q_offset 256
    (1, 8, 2, 160, 96, 128, False, 0, torch.float32),     # cross, sk < sq
]
SLICE = (4, 32, 32, 512, 512, 128, True, 0, torch.bfloat16)  # llama-7b prefill
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# rows 0..99 see no key (keys start at position 100); the pair of their q
# block with key block 0 is visited, so they get the mean of v there
MASKED_CASES = [
    (1, 4, 2, 256, 256, 128, True, 0, torch.bfloat16),    # wgmma design
    (1, 4, 2, 256, 256, 64, True, 0, torch.float32),      # ffma design
    (1, 4, 2, 256, 256, 128, True, 16, torch.float32),    # ffma, window
    (1, 4, 2, 256, 256, 32, True, 0, torch.float32),      # template (f32, d = 32)
    (1, 4, 2, 256, 256, 256, True, 0, torch.bfloat16),    # wgmma, 64-key tiles (d = 256)
    (1, 4, 2, 256, 256, 256, True, 0, torch.float32),     # ffma, 32-row q tiles (d = 256)
]
MASKED_OFFSETS = {"q_offset": 0, "kv_offset": 100}
# float32 at d = 128 reached through views: a (b, s, h, d) projection
# transposed (the ffma design reads its strides) and a base 4 bytes past a
# 16-byte boundary (the template)
VIEW_CASE = (2, 8, 2, 333, 333, 128, True, 0, torch.float32)


def _expected_flash_design(case, step: bool = False) -> str:
    """The shape rule at the contiguous inputs of ``_inputs``: bf16 wgmma
    and float32 ffma at head dim 64, 128 and 256 (the ring step 64 and
    128), else the template."""
    d, dt = case[5], case[-1]
    if d not in ((64, 128) if step else (64, 128, 256)):
        return "template"
    return {torch.bfloat16: "wgmma", torch.float32: "ffma"}.get(dt, "template")


def _served_by(ops, kernel: str, fn):
    """Run ``fn`` once; its result and the design whose count moved."""
    before = ops.design_counts()[kernel]
    out = fn()
    torch.cuda.synchronize()
    after = ops.design_counts()[kernel]
    moved = [d for d in after if after[d] != before[d]]
    assert len(moved) == 1 and after[moved[0]] == before[moved[0]] + 1, (before, after)
    return out, moved[0]


def _sum_counts(per_rank: list[dict], kernel: str) -> dict:
    """One kernel's ``design_counts()`` entry summed over ranks."""
    return {d: sum(r[kernel][d] for r in per_rank) for d in per_rank[0][kernel]}


def _path_design(counts: dict) -> str:
    """The design of every launch counted in ``counts`` (one kernel's
    ``design_counts()`` entry), or ``"mixed"``."""
    used = [d for d, n in counts.items() if n]
    return used[0] if len(used) == 1 else "mixed" if used else "none"


def _ptxas_kernels(log: str) -> list[dict]:
    """Per compiled kernel in an ``nvcc -Xptxas -v`` log: registers, spill
    stores and loads, static shared memory; the kernel named by its
    template arguments (mangled ``Li128E`` / ``Lb1E`` read as 128 / 1)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = re.search(r"\d([a-z][a-z_]*_kernel)I(.*?)EEv", m.group(1))
            args = re.findall(r"L[ib](\d+)E", name.group(2)) if name else []
            cur = {"kernel": f"{name.group(1)}<{','.join(args)}>" if name else m.group(1),
                   "registers": None, "spill_stores": None, "spill_loads": None, "smem": 0}
            out.append(cur)
        elif cur is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
                cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
            if m := re.search(r"Used (\d+) registers", ln):
                cur["registers"] = int(m[1])
            if m := re.search(r"(\d+) bytes smem", ln):
                cur["smem"] = int(m[1])
    return out


def _flash_template(fa, q, k, v, causal: bool, window: int = 0, q_offset: int = 0,
                    kv_offset: int = 0):
    """(launch, output): one launch of the template design's C entry at
    these inputs, for timing it beside the wgmma design in the same run.
    The wrapper picks a design by its shape rule alone; this calls the
    other entry directly and moves no counter."""
    lib, (b, hq, sq, d), (hkv, sk) = fa._lib(), q.shape, k.shape[1:3]
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), fa._DTYPES[q.dtype],
            b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], d ** -0.5, int(causal), window, q_offset, kv_offset,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = lib.flash_attention_fwd(*args)
        if err:
            raise RuntimeError(f"template flash_attention_fwd: cudaError {err}")
    return launch, o


def _mm_template(mm, x, w):
    """(launch, output) of the template design's ``matmul_fwd`` or
    ``gmm_fwd`` entry, as ``_flash_template``."""
    lib = mm._lib()
    out = torch.empty((*x.shape[:-1], w.shape[-1]), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), mm._DTYPES[x.dtype])
    strides = (*x.stride(), *w.stride(), *out.stride())
    if x.dim() == 3:
        (e, c, k), n = x.shape, w.shape[2]
        fn, args = lib.gmm_fwd, (*ptrs, e, c, n, k, *strides, stream)
    else:
        (m, k), n = x.shape, w.shape[1]
        fn, args = lib.matmul_fwd, (*ptrs, m, n, k, *strides, stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"template {fn.__name__}: cudaError {err}")
    return launch, out


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _inputs(case, seed=0, device="cuda"):
    b, hq, hkv, sq, sk, d, causal, window, dt = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(device=device, dtype=dt)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, q_offset=sk - sq if causal else 0)
    return q, k, v, kw


def _flash_view_parity(fa, ops, ref) -> list[dict]:
    """float32 at d = 128 through views: the (b, s, h, d) layout transposed
    (ffma), and a base 4 bytes off 16 (template), against ``ref.attention``
    at the float32 tolerance."""
    b, hq, hkv, s, _, d, causal, window, dt = VIEW_CASE
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to("cuda").transpose(1, 2)
               for h in (hq, hkv, hkv))
    flat = torch.zeros(q.numel() + 4, device="cuda")
    q_off = flat[1:q.numel() + 1].view(b, hq, s, d)
    q_off.copy_(q)
    out = []
    for name, qq, want_design in (("bshd_views", q, "ffma"), ("misaligned_base", q_off,
                                                              "template")):
        assert fa.design(qq, k, v) == want_design, name
        got, design = _served_by(ops, "flash_attention", lambda: ops.flash_attention(
            qq, k, v, causal=causal, window=window, impl="kernel"))
        assert design == want_design, (name, design)
        err = _max_err(got, ref.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                          causal=causal, window=window), TOL[dt],
                       f"flash {name} {VIEW_CASE}")
        out.append({"case": f"{VIEW_CASE} {name}", "offsets": None, "design": design,
                    "max_abs_err": err, "ok": True})
        log("parity", f"{VIEW_CASE} {name} [{design}]: max|kernel - attention| = {err:.3e} "
                      f"(tol {TOL[dt]}) ok")
    return out


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
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gmm, ops, ref

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
    t0 = time.perf_counter()
    names = ["flash_attention", "matmul"]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:  # one nvcc each
        builds = dict(zip(names, pool.map(_build.build, names)))
    t_build = time.perf_counter() - t0
    fa.build_info(), mm.build_info(), moe_gmm.build_info()  # bind the entry points
    results["build"] = {"wall_s": t_build}
    for name, built in builds.items():
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "ptxas info" in ln or "spill" in ln]
        log("build", f"{name}.cu in {built.build_s:.1f} s -> {built.path.name}")
        for ln in ptxas:
            log("build", ln)
        results["build"][f"{name}_s"] = built.build_s
        results["build"][f"{name}_ptxas"] = ptxas
    log("build", f"both sources built side by side in {t_build:.1f} s "
                 "(matmul.cu holds matmul_fwd and gmm_fwd)")
    def dynamic_smem(kernel: str) -> int:  # set at launch; ptxas reports static only
        if kernel.startswith("flash_wgmma_kernel<"):  # <D, STEP>
            d = int(kernel[len("flash_wgmma_kernel<"):].split(",")[0])
            return fa._lib().flash_attention_wgmma_smem_bytes(d)
        if kernel.startswith("flash_ffma_kernel<"):  # <D, STEP>
            d = int(kernel[len("flash_ffma_kernel<"):].split(",")[0])
            return fa._lib().flash_attention_ffma_smem_bytes(d)
        if kernel.startswith("mm_ffma_kernel<"):
            return mm._lib().matmul_ffma_smem_bytes()
        return mm._lib().matmul_wgmma_smem_bytes()
    wg_kernels = [dict(k, dynamic_smem=dynamic_smem(k["kernel"]))
                  for built in builds.values() for k in _ptxas_kernels(built.log)
                  if "wgmma_kernel" in k["kernel"] or "ffma_kernel" in k["kernel"]]
    for k in wg_kernels:
        log("build", f"{k['kernel']}: {k['registers']} registers, spill stores "
                     f"{k['spill_stores']} B, spill loads {k['spill_loads']} B, static smem "
                     f"{k['smem']} B, dynamic smem {k['dynamic_smem']} B")
    # flash wgmma and ffma <64|128, forward|step> and <256, forward>,
    # matmul/gmm wgmma and ffma <grouped, a_mn, b_mn>
    assert len(wg_kernels) == 5 + 5 + 8 + 8, [k["kernel"] for k in wg_kernels]
    for name in ("flash_wgmma_kernel<256,0>", "flash_ffma_kernel<256,0>"):
        assert name in [k["kernel"] for k in wg_kernels], (name, wg_kernels)
        assert dynamic_smem(name) > 0, name
    spilled = [k["kernel"] for k in wg_kernels if k["spill_stores"] or k["spill_loads"]]
    assert not spilled, f"ptxas spills registers in {spilled}"
    results["build"]["wgmma_kernels"] = wg_kernels

    # 3. kernel parity ----------------------------------------------------------
    parity = []
    masked = [(case, offsets) for case in MASKED_CASES for offsets in [MASKED_OFFSETS]]
    for case, offsets in [(c, None) for c in ATT_CASES + EXTRA_CASES + [SLICE]] + masked:
        q, k, v, kw = _inputs(case)
        plain = ref.attention
        if offsets is not None:  # rows that see no key: the TPU kernel's tiles decide
            kw.update(offsets)
            plain = ref.attention_tiled
        want_design = fa.design(q, k, v)
        got, design = _served_by(ops, "flash_attention",
                                 lambda: ops.flash_attention(q, k, v, impl="kernel", **kw))
        assert design == want_design == _expected_flash_design(case), (case, design)
        want = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = TOL[case[-1]]
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        parity.append({"case": str(case), "offsets": offsets, "design": design,
                       "max_abs_err": float(err.max()), "ok": ok})
        log("parity", f"{case}{' ' + str(offsets) if offsets else ''} [{design}]: "
                      f"max|kernel - {plain.__name__}| = {float(err.max()):.3e} "
                      f"(tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees at {case} {offsets}")
    slice_err = parity[len(ATT_CASES + EXTRA_CASES)]["max_abs_err"]
    parity += _flash_view_parity(fa, ops, ref)
    assert {p["design"] for p in parity} == {"wgmma", "ffma", "template"}
    assert {p["design"] for p in parity if "float32" in p["case"]} == {"ffma", "template"}
    results["parity"] = parity

    # 4. kernel timing at the serving path's shape ----------------------------------
    q, k, v, kw = _inputs(SLICE, seed=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    assert fa.design(q, k, v) == "wgmma"
    template, o_template = _flash_template(fa, q, k, v, causal=True)
    template()
    _max_err(o_template, ref.attention(q, k, v, **kw), TOL[torch.bfloat16],
             "template flash at the serving shape")
    t_kernel = _time_ms(lambda: ops.flash_attention(q, k, v, impl="kernel", **kw), 50)
    t_device = _device_ms(lambda: ops.flash_attention(q, k, v, impl="kernel", **kw), 20,
                          "flash_wgmma_kernel")
    t_template = _time_ms(template, 10)
    t_plain = _time_ms(lambda: ref.attention(q, k, v, **kw), 5)
    t_lib = _time_ms(lambda: sdpa(q, k, v, is_causal=True), 50)
    t_lib_device = _device_ms(lambda: sdpa(q, k, v, is_causal=True), 20, None)
    t_bwd_plain = _attention_backward_ms(ref, q, k, v, kw)
    bound_ms, bound_by, nbytes, nops = _attention_bound_ms(SLICE, ref)
    log("timing", f"flash_attention {SLICE[:6]} bf16 causal: kernel (wgmma) {t_kernel:.4f} "
                  f"ms ({t_device:.4f} ms device time), template {t_template:.4f} ms "
                  f"({t_template / t_kernel:.1f}x), plain "
                  f"{t_plain:.4f} ms, sdpa {t_lib:.4f} ms ({t_lib_device:.4f} ms device "
                  f"time), bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {nops} ops); "
                  f"the backward (the plain version's VJP, from saved q, k, v) "
                  f"{t_bwd_plain:.4f} ms")
    results["timing"] = {"kernel_ms": t_kernel, "device_ms": t_device,
                         "template_ms": t_template,
                         "plain_ms": t_plain, "library_ms": t_lib,
                         "library_device_ms": t_lib_device,
                         "backward_plain_ms": t_bwd_plain,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": nbytes, "ops": nops}
    del q, k, v, o_template
    results["timing_engine"] = _engine_flash_timing(fa, ops, ref)
    # float32 at the executor call's shape (the ffma design)
    results["timing_f32"] = _flash_timing(fa, ops, ref, SLICE[:-1] + (torch.float32,),
                                          "the executor's prefill", seed=1, iters=10)
    torch.cuda.empty_cache()

    # 5. serve llama-7b, full width and depth --------------------------------------
    cfg = get_config("llama-7b")
    results["serve"] = _serve_phase(cfg, ops)
    launches = results["serve"]["launches"]

    # 6. slice parity: the card (kernel) against the CPU (plain path) ------------
    results["slice_parity"] = _slice_parity(cfg, ops)

    # 7-8. matmul and ring-step parity --------------------------------------------
    results["matmul_parity"] = _matmul_parity(cfg, ops, ref)
    mm_err = results["matmul_parity"]["qproj_bf16_max_abs_err"]
    results["step_parity"] = _step_parity(ops, ref)
    step_err = results["step_parity"]["serving_bf16_max_abs_err"]

    # 9. timing of the matmul and ring-step kernels ---------------------------------
    results["matmul_timing"] = _matmul_timing(cfg, ops, ref)
    results["step_timing"] = _step_timing(ops, ref)
    results["step_timing_f32"] = _step_timing(ops, ref, torch.float32)

    # 10. the executor path on one card -------------------------------------------
    results["executor"] = _executor_path(cfg, ops)

    # 11. the ring path: 4 gloo ranks on the card ---------------------------------------
    results["ring"] = _ring_path()

    # 12-13. gmm parity and timing -------------------------------------------------------
    moe_cfg = get_config("qwen2-moe-a2.7b")
    results["gmm_parity"] = _gmm_parity(moe_cfg, get_config("mixtral-8x7b"), ops, ref)
    results["gmm_timing"] = _gmm_timing(moe_cfg, get_config("mixtral-8x7b"), ops, ref)

    # 14. serve qwen2-moe-a2.7b, full width and depth --------------------------------------
    results["serve_moe"] = _serve_phase(moe_cfg, ops)

    # 15. MoE slice parity: the card (gmm kernel) against the CPU -------------------------
    results["moe_slice_parity"] = _slice_parity(moe_cfg, ops)

    # 16. the a2a path: 4 gloo ranks on the card, experts sharded 4 ways ---------------------
    results["a2a"] = _a2a_path()

    # 17. train parity: the card (kernel forward, plain backward) against the CPU -----------
    results["train_parity"] = _train_parity(cfg, ops)

    # 18. train llama-7b at full width, 8 layers, bf16 --------------------------------------
    results["train"] = _train_phase(cfg, ops, fa)

    # 19. the paper's Experiment 2: the FFNN's gradient program at AmazonCat-14K sizes -------
    results["ffnn"] = _ffnn_phase(ops)

    # 20. the continuous-batching engine: llama-7b at full width and depth, bf16 -----------
    lens = np.random.default_rng(0).integers(192, 513, size=8).tolist()
    results["engine"] = _engine_phase(cfg, ops, results["serve"]["profile"]["decode_step"],
                                      slots=4, block=16, max_seq=528, lens=lens, max_new=16)

    # 21. the engine on qwen2-moe-a2.7b at full width and depth, bf16 ---------------------
    results["engine_moe"] = _engine_phase(
        moe_cfg, ops, results["serve_moe"]["profile"]["decode_step"], slots=2, block=16,
        max_seq=520, lens=[384, 448, 512], max_new=8)

    # 22. engine parity: the card against the CPU, llama-7b and qwen2-moe width, 2 layers, f32
    results["engine_parity"] = _engine_parity(cfg, ops)
    results["engine_parity_moe"] = _engine_parity(moe_cfg, ops)

    # 23. the zoo's flash shapes: hymba's (wgmma, GQA 5:1, window 1024), paligemma's (d = 256)
    results["zoo_timing"] = _zoo_flash_timing(fa, ops, ref)

    # 24-26. serve hymba-1.5b, xlstm-125m and paligemma-3b at full width and depth, bf16
    results["zoo_serve"] = _zoo_serve(ops)

    # 27. zoo slice parity (f32, card against CPU) and the zoo's executor path (bf16)
    results["zoo_parity"] = _zoo_slice_parity(ops)
    results["zoo_executor"] = _zoo_executor(ops)

    # 28. the engine on hymba-1.5b at full size, and the xlstm engine parity (f32)
    hymba = get_config("hymba-1.5b")
    hymba_lens = np.random.default_rng(28).integers(1100, 1501, 3).tolist()
    results["engine_hymba"] = _engine_phase(
        hymba, ops, results["zoo_serve"]["hymba-1.5b"]["profile"]["decode_step"], slots=2,
        block=16, max_seq=1520, lens=hymba_lens, max_new=8, baseline=True)
    results["engine_hymba_f32"] = _engine_f32_full(hymba, ops, slots=2, block=16,
                                                   max_seq=1520, lens=hymba_lens, max_new=8)
    results["engine_parity_xlstm"] = _engine_parity(get_config("xlstm-125m"), ops)
    zoo_designs = _zoo_design_counts(results)
    # every flash launch of the zoo takes wgmma (bf16) or ffma (float32), none the template
    assert zoo_designs["flash_attention"]["template"] == 0, zoo_designs["flash_attention"]

    # 29. the pipelined path: llama-7b's prefill graph on 1, 2 and 4 gloo ranks of a pp axis
    results["pipeline"] = _pipeline_path(cfg)

    # 30. the static verifier: the CLI, the memory pass against the allocator, the registry
    results["analysis"] = _analysis_phase(cfg, results)
    pipe_designs = results["pipeline"]["designs_total"]

    mt, st = results["matmul_timing"]["bfloat16"], results["step_timing"]
    m32 = results["matmul_timing"]["float32"]
    gt, g32 = results["gmm_timing"]["w1_prefill"], results["gmm_timing"]["w1_prefill_f32"]
    gdec = results["gmm_timing"]["w1_decode"]
    e16, e32 = results["timing_engine"]["bfloat16"], results["timing_engine"]["float32"]
    f32b4, st32 = results["timing_f32"], results["step_timing_f32"]
    ring32 = results["ring"]["float32"]
    serve_designs = results["serve"]["designs"]
    ring16 = results["ring"]["bfloat16"]
    ex32 = results["executor"]["float32"]
    kernels = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:134",
         "design": _path_design(serve_designs["flash_attention"]),
         "launches": launches["flash_attention"], "max_abs_err": slice_err,
         "ms": t_kernel, "template_ms": results["timing"]["template_ms"],
         "plain_ms": t_plain, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": t_lib,
         "library_device_ms": results["timing"]["library_device_ms"],
         "device_ms": results["timing"]["device_ms"],
         "backward_plain_ms": results["timing"]["backward_plain_ms"],
         "train_launches_per_step": results["train"]["flash_launches_per_step"],
         "engine_launches": results["engine"]["launches"]["flash_attention"],
         "engine_design": _path_design(results["engine"]["designs"]["flash_attention"]),
         "engine_moe_launches": results["engine_moe"]["launches"]["flash_attention"],
         "engine_shape_device_ms": e16["device_ms"], "engine_shape_bound_ms": e16["bound_ms"],
         "engine_shape_library_device_ms": e16["library_device_ms"],
         "f32_design": e32["design"], "f32_ms": e32["kernel_ms"],
         "f32_device_ms": e32["device_ms"], "f32_template_ms": e32["template_device_ms"],
         "f32_plain_ms": e32["plain_ms"],
         "f32_bound_ms": e32["bound_ms"], "f32_bound_by": e32["bound_by"],
         "f32_library_ms": e32["library_ms"],
         "f32_library_device_ms": e32["library_device_ms"],
         "f32_b4_design": f32b4["design"], "f32_b4_ms": f32b4["kernel_ms"],
         "f32_b4_device_ms": f32b4["device_ms"],
         "f32_b4_template_ms": f32b4["template_device_ms"],
         "f32_b4_plain_ms": f32b4["plain_ms"], "f32_b4_bound_ms": f32b4["bound_ms"],
         "f32_b4_bound_by": f32b4["bound_by"], "f32_b4_library_ms": f32b4["library_ms"],
         "f32_b4_library_device_ms": f32b4["library_device_ms"],
         "f32_executor_launches": ex32["launches"]["flash_attention"],
         "f32_executor_design": _path_design(ex32["designs"]["flash_attention"]),
         "f32_train_parity_launches": sum(results["train_parity"]["launches"]),
         "f32_train_parity_design": _path_design(results["train_parity"]["designs"]),
         "f32_engine_parity_launches": results["engine_parity"]["launches"]["flash_attention"],
         "f32_engine_parity_design": _path_design(
             results["engine_parity"]["designs"]["flash_attention"]),
         "zoo": {name: {k: z[k] for k in ("design", "device_ms", "template_device_ms",
                                          "plain_ms", "library_device_ms", "library_kernels",
                                          "bound_ms", "bound_by", "max_abs_err")}
                 for name, z in results["zoo_timing"].items()},
         "zoo_serve_launches": {a: r["launches"]["flash_attention"]
                                for a, r in results["zoo_serve"].items()},
         "zoo_serve_designs": {a: _path_design(r["designs"]["flash_attention"])
                               for a, r in results["zoo_serve"].items()},
         "zoo_launches_by_design": zoo_designs["flash_attention"],
         "pipeline_launches": sum(pipe_designs["flash_attention"].values()),
         "pipeline_design": pipe_designs["flash_attention"]},
        {"name": "flash_attention_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:274",
         "design": _path_design(_sum_counts(ring16["designs_per_rank"],
                                            "flash_attention_step")),
         "launches": ring16["launches_total"]["flash_attention_step"],
         "max_abs_err": step_err, "ms": st["kernel_ms"], "template_ms": st["template_ms"],
         "wrapper_ms": st["wrapper_ms"], "plain_ms": st["plain_ms"],
         "bound_ms": st["bound_ms"], "bound_by": st["bound_by"], "library_ms": None,
         "f32_design": _path_design(_sum_counts(ring32["designs_per_rank"],
                                                "flash_attention_step")),
         "f32_launches": ring32["launches_total"]["flash_attention_step"],
         "f32_max_abs_err": results["step_parity"]["serving_f32_max_abs_err"],
         "f32_ms": st32["kernel_ms"], "f32_template_ms": st32["template_ms"],
         "f32_wrapper_ms": st32["wrapper_ms"], "f32_plain_ms": st32["plain_ms"],
         "f32_bound_ms": st32["bound_ms"], "f32_bound_by": st32["bound_by"]},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:57",
         "design": _path_design(results["executor"]["bfloat16"]["designs"]["matmul"]),
         "launches": results["executor"]["bfloat16"]["launches"]["matmul"],
         "max_abs_err": mm_err, "ms": mt["kernel_ms"], "template_ms": mt["template_ms"],
         "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"], "bound_by": mt["bound_by"],
         "library_ms": mt["library_ms"],
         "f32_design": _path_design(ex32["designs"]["matmul"]),
         "f32_launches": ex32["launches"]["matmul"],
         "f32_max_abs_err": results["matmul_parity"]["qproj_f32_max_abs_err"],
         "f32_ms": m32["kernel_ms"], "f32_template_ms": m32["template_ms"],
         "f32_plain_ms": m32["plain_ms"], "f32_library_ms": m32["library_ms"],
         "f32_bound_ms": m32["bound_ms"], "f32_bound_by": m32["bound_by"],
         "ffnn_launches_per_step": results["ffnn"]["matmul_launches_per_step"],
         "ffnn_design": _path_design(results["ffnn"]["designs"]["matmul"]),
         "zoo_executor_launches": {a: r["launches"]["matmul"]
                                   for a, r in results["zoo_executor"].items()},
         "zoo_launches_by_design": zoo_designs["matmul"],
         "pipeline_launches": sum(pipe_designs["matmul"].values()),
         "pipeline_design": pipe_designs["matmul"]},
        {"name": "gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/moe_gmm.py:58",
         "design": _path_design(results["serve_moe"]["designs"]["gmm"]),
         "launches": results["serve_moe"]["launches"]["gmm"],
         "max_abs_err": results["gmm_parity"]["qwen2_prefill_bf16_max_abs_err"],
         "ms": gt["kernel_ms"], "template_ms": gt["template_ms"], "plain_ms": gt["plain_ms"],
         "bound_ms": gt["bound_ms"], "bound_by": gt["bound_by"],
         "library_ms": gt["library_ms"],
         "f32_design": _path_design(results["moe_slice_parity"]["designs"]["gmm"]),
         "f32_launches": results["moe_slice_parity"]["launches"]["gmm"],
         "f32_ms": g32["kernel_ms"], "f32_template_ms": g32["template_ms"],
         "f32_plain_ms": g32["plain_ms"], "f32_library_ms": g32["library_ms"],
         "f32_bound_ms": g32["bound_ms"], "f32_bound_by": g32["bound_by"],
         "decode_ms": gdec["kernel_ms"], "decode_plain_ms": gdec["plain_ms"],
         "decode_bound_ms": gdec["bound_ms"], "decode_bound_by": gdec["bound_by"],
         "decode_library_ms": gdec["library_ms"],
         "engine_launches": results["engine_moe"]["launches"]["gmm"],
         "engine_design": _path_design(results["engine_moe"]["designs"]["gmm"]),
         "zoo_launches_by_design": zoo_designs["gmm"]},
    ]}
    kernels["kernels"][1]["zoo_launches_by_design"] = zoo_designs["flash_attention_step"]
    results.update(kernels)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))

    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


def _zoo_design_counts(results: dict) -> dict:
    """Every kernel's launches by design over the zoo's counted runs
    (phases 24-28): the three serve calls, the prefix prefill excluded (it
    ran with the counters of its own check), the slice parities, the two
    executor calls and both engines' second runs."""
    runs = [r["designs"] for r in results["zoo_serve"].values()]
    runs += [{"flash_attention": r["designs"]} for r in results["zoo_parity"].values()]
    runs += [r["designs"] for r in results["zoo_executor"].values()]
    runs += [results["engine_hymba"]["designs"], results["engine_hymba_f32"]["designs"],
             results["engine_parity_xlstm"]["designs"]]
    out = {k: dict.fromkeys(DESIGNS_ALL, 0) for k in ("flash_attention", "flash_attention_step",
                                                      "matmul", "gmm")}
    for run in runs:
        for kernel, by_design in run.items():
            for d, n in by_design.items():
                out[kernel][d] += n
    return out


DESIGNS_ALL = ("wgmma", "ffma", "template")
ENGINE_PREFILL = (1, 32, 32, 512, 512, 128, True, 0)  # one llama-7b request, 512 bucket


def _engine_flash_timing(fa, ops, ref) -> dict:
    """The forward kernel at one bucketed prefill of the engine (batch 1,
    the 512 bucket, causal) in bf16 (the wgmma design) and in float32 (the
    ffma design, which the float32 paths take): held against its plain
    version, then its time by CUDA events and its device time
    (torch.profiler), the template design's device time at the same inputs
    (its C entry), the plain version, SDPA on the same inputs (events and
    device time) and the bound."""
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        case = ENGINE_PREFILL + (dt,)
        res[str(dt).split(".")[1]] = _flash_timing(fa, ops, ref, case, "an engine prefill",
                                                  seed=3, iters=20)
    torch.cuda.empty_cache()
    return res


FLASH_DEVICE_KERNEL = {"wgmma": "flash_wgmma_kernel", "ffma": "flash_ffma_kernel",
                       "template": "flash_fwd_kernel"}


def _flash_timing(fa, ops, ref, case, what: str, seed: int, iters: int) -> dict:
    """The forward kernel at ``case`` (causal) against its plain version,
    then by CUDA events and device time, the template design's device time
    (its C entry, on the same inputs), the plain version, SDPA (events and
    device time) and the bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt = case[-1]
    q, k, v, kw = _inputs(case, seed=seed)
    design = fa.design(q, k, v)
    assert design == _expected_flash_design(case), design
    kernel = lambda: ops.flash_attention(q, k, v, impl="kernel", **kw)  # noqa: E731
    err = _max_err(kernel(), ref.attention(q, k, v, **kw), TOL[dt], f"flash at {what}, {dt}")
    template, o_template = _flash_template(fa, q, k, v, causal=True)
    template()
    _max_err(o_template, ref.attention(q, k, v, **kw), TOL[dt], f"template flash at {what}")
    t_kernel = _time_ms(kernel, iters)
    t_device = _device_ms(kernel, iters // 2, FLASH_DEVICE_KERNEL[design])
    t_template = _device_ms(template, 5, "flash_fwd_kernel")
    t_plain = _time_ms(lambda: ref.attention(q, k, v, **kw), 3)
    t_lib = _time_ms(lambda: sdpa(q, k, v, is_causal=True), iters)
    t_lib_device = _device_ms(lambda: sdpa(q, k, v, is_causal=True), iters // 2, None)
    bound_ms, bound_by, nbytes, nops = _attention_bound_ms(case, ref)
    log("timing", f"flash_attention {case[:6]} {dt} causal ({what}): kernel ({design}) "
                  f"{t_kernel:.4f} ms ({t_device:.4f} ms device time), template "
                  f"{t_template:.4f} ms device time ({t_template / t_device:.2f}x), plain "
                  f"{t_plain:.4f} ms, sdpa {t_lib:.4f} ms ({t_lib_device:.4f} ms device "
                  f"time), bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {nops} ops); "
                  f"max|kernel - plain| {err:.3e}")
    del q, k, v, o_template
    return {"case": str(case), "design": design, "max_abs_err": err, "kernel_ms": t_kernel,
            "device_ms": t_device, "template_device_ms": t_template, "plain_ms": t_plain,
            "library_ms": t_lib, "library_device_ms": t_lib_device, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "ops": nops}


def _attn_layers(cfg) -> int:
    """Layers that run attention (attn and hymba blocks): one flash launch
    each a prefill."""
    return sum(1 for blk in cfg.blocks() if blk in ("attn", "hymba"))


def _serve_phase(cfg, ops, b: int = 4, prompt_len: int = 512, max_new: int = 16,
                 flash_design: str = "wgmma") -> dict:
    """Serve ``cfg`` at full width and depth on the card (bf16, random
    weights from seed 0) through ``launch.serve.serve``: planned through a
    plan-cache file (cold here, a hit in the serve call), a short warm-up
    request, then the counted request with the launch counters set to 0
    just before it and read just after.  Then one prefill and one decode
    step, each counted and profiled.  Every flash launch takes
    ``flash_design``, every matmul and gmm launch wgmma.  Where the config
    has a prefix (paligemma), one more prefill through ``make_prefill_step``
    on ``prefix_len`` seeded prefix embeddings and ``prompt_len -
    prefix_len`` tokens, counted and profiled the same way."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.eingraphs import program_for

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
        n_params = sum(t.numel() for t in tree.leaves(params))
        log("serve", f"{cfg.name}: planned cold in {t_cold:.4f} s; {n_params} params "
                     f"made on the card in {t_init:.1f} s")
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
        designs = ops.design_counts()
        peak = torch.cuda.max_memory_allocated()
    assert warm.stats["hits"] == 1 and warm.stats["misses"] == 0, warm.stats
    # gmm: w1 (w3) and w2 per MoE layer, in prefill and in every decode step
    per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    per_prefill = {"flash_attention": _attn_layers(cfg), "flash_attention_step": 0,
                   "matmul": 0, "gmm": per_layer * cfg.n_layers}
    per_decode = dict(per_prefill, flash_attention=0)
    want = dict(per_prefill, gmm=per_layer * cfg.n_layers * (1 + stats["decode_steps"]))
    assert launches == want, (launches, want)
    # bf16 with tensors TMA can address: every flash and gmm launch of the
    # serve call took the wgmma design
    for kernel in ("flash_attention", "matmul", "gmm"):
        want_design = flash_design if kernel == "flash_attention" else "wgmma"
        assert designs[kernel][want_design] == launches[kernel] == sum(
            designs[kernel].values()), designs
    assert gen.shape == (b, max_new), gen.shape
    assert ((gen >= 0) & (gen < cfg.vocab_padded)).all()
    # where the time goes: one prefill and one decode step, counted, then profiled
    prefill, decode = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device="cuda")
        ops.reset_launch_counts()
        logits, caches = prefill(params, {"tokens": tokens})
        got_prefill = ops.launch_counts()
        assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
        caches = serve_mod.prepare_decode_caches(cfg, caches, prompt_len,
                                                 prompt_len + max_new)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        ops.reset_launch_counts()
        decode(params, tok, caches, prompt_len)
        got_decode = ops.launch_counts()
        assert (got_prefill, got_decode) == (per_prefill, per_decode), (got_prefill,
                                                                         got_decode)
        breakdown = {
            "prefill": _profile(lambda: prefill(params, {"tokens": tokens})),
            "decode_step": _profile(lambda: decode(params, tok, caches, prompt_len)),
        }
        if cfg.prefix_len:  # the stubbed vision tower's patch embeddings, then tokens
            pe = torch.as_tensor(np.random.default_rng(1).normal(
                size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32), device="cuda")
            pbatch = {"tokens": tokens[:, :prompt_len - cfg.prefix_len], "prefix_embeds": pe}
            ops.reset_launch_counts()
            logits_pe, _ = prefill(params, pbatch)
            got_prefix = ops.launch_counts()
            assert got_prefix == per_prefill, got_prefix
            assert ops.design_counts()["flash_attention"][flash_design] == _attn_layers(cfg)
            assert logits_pe.shape == (b, 1, cfg.vocab_padded)
            assert bool(torch.isfinite(logits_pe).all()), "non-finite prefix prefill logits"
            breakdown["prefix_prefill"] = _profile(lambda: prefill(params, pbatch))
            del pe, pbatch, logits_pe
    for name, br in breakdown.items():
        log("profile", f"{cfg.name} {name}: wall {br['wall_ms']:.3f} ms, device busy "
                       f"{br['device_ms']:.3f} ms (idle share {br['idle_share']:.3f}), "
                       f"{br['kernels']} kernels; device ms by kind {br['by_kind_ms']}; "
                       f"top {br['top_kernels_ms'][:3]}")
    log("serve", f"{cfg.name} bf16 b={b} prompt={prompt_len} new={max_new}: "
                 f"t_plan_s={stats['t_plan_s']:.4f} (cache hit) "
                 f"t_prefill_s={stats['t_prefill_s']:.4f} "
                 f"t_decode_s={stats['t_decode_s']:.4f} tok_per_s={stats['tok_per_s']:.2f} "
                 f"max_memory_allocated={peak} launches={launches} by design {designs}; "
                 f"per prefill {got_prefill}, per decode step {got_decode}")
    log("serve", f"generations[0] = {gen[0].tolist()}")
    res = {k: v for k, v in stats.items() if k != "policy"}
    res.update({"t_plan_cold_s": t_cold, "max_memory_allocated": peak,
                "launches": launches, "designs": designs,
                "launches_per_prefill": got_prefill,
                "launches_per_decode_step": got_decode, "n_params": n_params,
                "flash_design": flash_design,
                "batch": b, "prompt_len": prompt_len, "max_new": max_new,
                "profile": breakdown})
    del params, logits, caches, tokens, tok
    torch.cuda.empty_cache()
    return res


def _slice_parity(cfg, ops) -> dict:
    """``cfg`` at full width, 2 layers, float32: the same weights on the
    card (the kernels) and on the CPU (the plain path); prefill logits and
    greedy tokens."""
    from repro_torch.core import tree
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = tf.init_params(cfg2, seed=1, device="cpu")
    gpu_params = tree.map(lambda t: t.to("cuda"), cpu_params)
    p2 = np.random.default_rng(1).integers(0, cfg2.vocab, size=(2, 64)).astype(np.int32)
    prefill = steps.make_prefill_step(cfg2)
    ops.reset_launch_counts()
    with torch.inference_mode():
        lg_gpu, _ = prefill(gpu_params, {"tokens": torch.as_tensor(p2, device="cuda")})
        launches = ops.launch_counts()
        designs = ops.design_counts()
        lg_cpu, _ = prefill(cpu_params, {"tokens": torch.as_tensor(p2)})
    per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    assert launches["flash_attention"] == 2 and launches["gmm"] == 2 * per_layer, launches
    lg_gpu, lg_cpu = lg_gpu.float().cpu(), lg_cpu.float()
    scale = float(lg_cpu.abs().max())
    diff = float((lg_gpu - lg_cpu).abs().max())
    # float32 end to end with TF32 off: the card and the CPU differ only in
    # the order of their sums (d_model- and d_ff-wide contractions)
    torch.testing.assert_close(lg_gpu, lg_cpu, rtol=1e-4, atol=1e-4 * scale)
    g_gpu, _ = serve_mod.serve(cfg2, p2, max_new=4, params=gpu_params, device="cuda")
    g_cpu, _ = serve_mod.serve(cfg2, p2, max_new=4, params=cpu_params, device="cpu")
    assert np.array_equal(g_gpu, g_cpu), (g_gpu, g_cpu)
    log("slice-parity", f"{cfg.name} width, 2 layers, f32: max|logit diff| = {diff:.3e} "
                        f"(max|logit| {scale:.3f}); launches {launches}; gmm launches by "
                        f"design {designs['gmm']}; greedy tokens equal: {g_gpu.tolist()}")
    del cpu_params, gpu_params
    torch.cuda.empty_cache()
    return {"max_abs_logit_diff": diff, "max_abs_logit": scale, "launches": launches,
            "designs": designs, "tokens": g_gpu.tolist()}


def _profile(fn, ranges: tuple[str, ...] = ()) -> dict:
    """``fn`` warmed up, timed once on the host clock (ending in a
    synchronize), then run twice more under torch.profiler, of which the
    second call is read: the device time of its kernels, by kind (this
    port's flash-attention, ring-step, matmul and gmm kernels of every
    design, cuBLAS matrix products, everything else), and the idle share
    of the unprofiled wall time (tracing itself slows the host down).
    A trace started late in a process can lose its first device events, so
    ``_fill_trace_start`` and the first call only fill that window, and a
    spin kernel between the calls marks where the read call starts.
    ``ranges`` names ``record_function`` ranges whose kernels' device time
    is reported too (``range_ms``, the read call's half of the ranges;
    those kernels also count in their kinds), for which the host's ops are
    traced as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    with profile(activities=activities) as prof:
        _fill_trace_start()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 16)  # the marker
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [e for e in device if "spin_kernel" in e.name]
    assert marks, "the trace lost the marker kernel"
    start = marks[-1].time_range.end
    by_kind = {"flash_attention": 0.0, "flash_step": 0.0, "matmul": 0.0, "gmm": 0.0,
               "gemm": 0.0, "other": 0.0}
    count = dict.fromkeys(by_kind, 0)
    by_name: dict[str, float] = {}
    n = 0
    for e in device:
        if (e.time_range.start < start or "Loading" in e.name or "Buffer" in e.name
                or e.name in ranges):  # a range's span on the device timeline, not a kernel
            continue
        n += 1
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        step = "true>" in name or "lb1e" in name  # flash_*_kernel<..., STEP>
        flash = any(k in name for k in ("flash_fwd_kernel", "flash_wgmma_kernel",
                                        "flash_ffma_kernel"))
        ours = any(k in name for k in ("mm_f32_kernel", "mm_bf16_kernel", "mm_wgmma_kernel",
                                       "mm_ffma_kernel"))
        grouped = "kernel<true" in name or "kernelilb1e" in name  # <GROUPED, ...>
        kind = ("flash_step" if flash and step else
                "flash_attention" if flash else
                "gmm" if ours and grouped else
                "matmul" if ours else
                "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet"))
                else "other")
        by_kind[kind] += ms
        count[kind] += 1
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    device_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    range_ms = {}
    for r in ranges:
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU
                      and e.name == r), key=lambda e: e.time_range.start)
        range_ms[r] = sum(e.device_time_total for e in evs[len(evs) // 2:]) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kernels": n, "range_ms": range_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "by_kind_ms": {k: round(v, 4) for k, v in by_kind.items()},
            "by_kind_count": count,
            "top_kernels_ms": [(k, round(v, 4)) for k, v in top]}


def _bound(nbytes: int, nops: int, dtype) -> tuple[float, str]:
    """(least ms on this card, what bounds it): bytes over the memory rate
    against operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, want, tol: float, what: str, atol: float | None = None) -> float:
    """max |got - want|; raises where |got - want| > atol + tol * |want|
    (``atol`` defaults to ``tol``)."""
    atol = tol if atol is None else atol
    err = (got.float() - want.float()).abs()
    if not bool((err <= atol + tol * want.float().abs()).all()):
        raise AssertionError(f"{what}: max|kernel - plain| = {float(err.max()):.3e} "
                             f"beyond tol {tol} (atol {atol})")
    return float(err.max())


MM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py


def _mm_shapes(cfg, m: int = 4 * 512) -> dict[str, tuple[int, int, int]]:
    """(m, k, n) of every product of llama-7b's prefill graph at b=4, s=512."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    return {"qkvo_proj": (m, d, cfg.n_heads * cfg.head_dim), "up_gate": (m, d, f),
            "down": (m, f, d), "lm_head": (m, d, v)}


def _mm_inputs(m, k, n, dt, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").to(dt)
    w = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).to(dt)
    return x, w


def _matmul_parity(cfg, ops, ref) -> dict:
    """The matmul kernel against ``ref.matmul`` on the card."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((128, 128, 128), f32), ((256, 384, 128), f32), ((128, 256, 512), bf16),
             ((64, 64, 64), f32),                                # tests/test_kernels.py
             ((200, 300, 77), f32), ((200, 300, 77), bf16),      # ragged
             ((1, 5, 3), f32), ((130, 17, 129), bf16),           # (f32: the template)
             ((200, 300, 76), f32), ((130, 20, 132), f32)]       # ragged, f32 ffma
    cases += [(shape, dt) for shape in _mm_shapes(cfg).values() for dt in (f32, bf16)]
    from repro_torch.kernels import matmul as mm

    out, qproj_err = [], None
    for (m, k, n), dt in cases:
        x, w = _mm_inputs(m, k, n, dt)
        want_design = mm.design(x, w)
        got, design = _served_by(ops, "matmul", lambda: ops.matmul(x, w, impl="kernel"))
        assert design == want_design, (m, k, n, dt, design)
        err = _max_err(got, ref.matmul(x, w), MM_TOL[dt], f"matmul {(m, k, n)} {dt}")
        out.append({"shape": [m, k, n], "dtype": str(dt), "design": design,
                    "max_abs_err": err})
        log("mm-parity", f"{(m, k, n)} {dt} [{design}]: max|kernel - plain| = {err:.3e} ok")
        if (m, k, n) in _mm_shapes(cfg).values():  # the path's: f32 ffma, bf16 wgmma
            assert design == ("wgmma" if dt == bf16 else "ffma"), design
        if (m, k, n) == _mm_shapes(cfg)["qkvo_proj"] and dt == bf16:
            qproj_err = err
    # strided views: each major of x and w, and a w at column stride 2
    x32, w32 = _mm_inputs(328, 200, 264, f32, seed=1)
    views = {"x_col_major": lambda x, w: (x.t().contiguous().t(), w),
             "w_col_major": lambda x, w: (x, w.t().contiguous().t()),
             "both_col_major": lambda x, w: (x.t().contiguous().t(), w.t().contiguous().t()),
             "w_col_stride_2": lambda x, w: (x, torch.stack([w, -w], dim=2).flatten(1)[:, ::2])}
    for dt in (f32, bf16):
        x, w = x32.to(dt), w32.to(dt)
        for name, view in views.items():
            xv, wv = view(x, w)
            got, design = _served_by(ops, "matmul", lambda: ops.matmul(xv, wv, impl="kernel"))
            ruled = "wgmma" if dt == bf16 else "ffma"
            want_design = ruled if name != "w_col_stride_2" else "template"
            assert design == want_design, (name, dt, design)
            err = _max_err(got, ref.matmul(x, w), MM_TOL[dt], f"matmul {name} {dt}")
            out.append({"shape": [328, 200, 264], "dtype": str(dt), "view": name,
                        "design": design, "max_abs_err": err})
            log("mm-parity", f"{name} (328, 200, 264) {dt} [{design}]: max|kernel - plain| "
                             f"= {err:.3e} ok")
    assert {c["design"] for c in out} == {"wgmma", "ffma", "template"}
    f32_designs = {c["design"] for c in out if c["dtype"] == str(f32)}
    assert f32_designs == {"ffma", "template"}, f32_designs
    return {"cases": out, "qproj_bf16_max_abs_err": qproj_err,
            "qproj_f32_max_abs_err": next(c["max_abs_err"] for c in out if c["dtype"] == str(f32)
                                          and c["shape"] == list(_mm_shapes(cfg)["qkvo_proj"]))}


STEP_CASES = [  # (b, hq, hkv, s, d, causal, window, dtype)
    (2, 4, 4, 64, 32, True, 0, torch.float32),
    (2, 4, 2, 64, 32, True, 0, torch.float32),     # GQA
    (1, 4, 1, 96, 64, True, 24, torch.float32),    # window, MQA
    (1, 4, 2, 64, 16, False, 0, torch.float32),
    (2, 4, 2, 128, 64, True, 0, torch.bfloat16),
    (1, 8, 2, 200, 128, True, 40, torch.bfloat16),  # blocks that divide no tile
    (2, 4, 2, 128, 64, True, 0, torch.float32),
    (1, 8, 2, 200, 128, True, 40, torch.float32),   # blocks that divide no tile
    (1, 4, 4, 512, 128, False, 0, torch.float32),   # no mask, several tiles a block
]
STEP_SERVING = (4, 32, 32, 512, 128, True, 0, torch.bfloat16)  # r = 4: blocks of 128
STEP_SERVING_F32 = STEP_SERVING[:-1] + (torch.float32,)  # the f32 ring's blocks


def _step_parity(ops, ref) -> dict:
    """The ring as each rank runs it: q block i at i*blk, the kv blocks in
    ring order (i, i-1, ...), fully masked blocks included.  Every carry
    against the plain step; the finalised chain against the forward
    kernel over the whole kv."""
    out, serving_err = [], {}
    for case, r in ([(c, r) for c in STEP_CASES for r in (2, 4)]
                    + [(STEP_SERVING, 4), (STEP_SERVING_F32, 4)]):
        b, hq, hkv, s, d, causal, window, dt = case
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = (torch.randn(sh, generator=g, device="cuda").to(dt)
                   for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        blk, tol, worst = s // r, TOL[dt], 0.0
        kw = dict(causal=causal, window=window)
        for i in range(r):
            qi = q[:, :, i * blk:(i + 1) * blk]
            carry = plain = None
            for t in range(r):
                j = (i - t) % r
                kj, vj = k[:, :, j * blk:(j + 1) * blk], v[:, :, j * blk:(j + 1) * blk]
                off = dict(q_offset=i * blk, kv_offset=j * blk, **kw)
                carry, design = _served_by(ops, "flash_attention_step",
                                           lambda: ops.flash_attention_step(
                                               qi, kj, vj, carry, impl="kernel", **off))
                # head dim 64 / 128 (blocks the rule addresses): bf16 wgmma, f32 ffma
                assert design == _expected_flash_design((0,) * 5 + (d, dt), step=True), design
                plain = ref.attention_step(qi, kj, vj, plain, **off)
                for part, got, want in zip("mla", carry, plain):
                    worst = max(worst, _max_err(got, want, tol,
                                                f"step {case} r={r} i={i} t={t} {part}"))
            fin = ops.attention_finalize(carry, dt)
            fwd = ops.flash_attention(qi, k, v, q_offset=i * blk, impl="kernel", **kw)
            worst = max(worst, _max_err(fin, fwd, tol, f"step chain {case} r={r} i={i}"))
        out.append({"case": str(case), "r": r, "design": design, "max_abs_err": worst})
        log("step-parity", f"{case} r={r} [{design}]: max|kernel - plain| = {worst:.3e} "
                           f"(tol {tol}) ok")
        if case in (STEP_SERVING, STEP_SERVING_F32):
            serving_err[str(dt).split(".")[1]] = worst
    assert {c["design"] for c in out} == {"wgmma", "ffma", "template"}
    return {"cases": out, "serving_bf16_max_abs_err": serving_err["bfloat16"],
            "serving_f32_max_abs_err": serving_err["float32"]}


def _matmul_timing(cfg, ops, ref) -> dict:
    """The kernel, the template design at the same inputs (its C entry),
    its plain version and ``torch.matmul`` (TF32 off) at every distinct
    product shape of llama-7b's prefill graph (m = 2048), in float32 (the
    ffma design) and in bf16 (the wgmma design); fewer iterations for the
    larger products.  ``res["float32"]`` and ``res["bfloat16"]`` are the
    q_proj shape (2048 x 4096 x 4096)."""
    from repro_torch.kernels import matmul as mm

    res = {"float32_shapes": {}, "bfloat16_shapes": {}}
    for dt in (torch.float32, torch.bfloat16):
        for name, (m, k, n) in _mm_shapes(cfg).items():
            x, w = _mm_inputs(m, k, n, dt, seed=3)
            item = x.element_size()
            nbytes, nops = (m * k + k * n + m * n) * item, 2 * m * k * n
            bound_ms, bound_by = _bound(nbytes, nops, dt)
            scale = max(1, round(nops / 68.7e9))  # fewer iterations for the larger products
            iters = (10 if dt == torch.float32 else 50) // scale or 1
            design = mm.design(x, w)
            assert design == ("wgmma" if dt == torch.bfloat16 else "ffma"), design
            template, _ = _mm_template(mm, x, w)
            t_kernel = _time_ms(lambda: ops.matmul(x, w, impl="kernel"), iters)
            t_template = _time_ms(template, max(1, 5 // scale), warmup=1)
            t_plain = _time_ms(lambda: ref.matmul(x, w), max(1, 10 // scale))
            t_lib = _time_ms(lambda: torch.matmul(x, w), iters)
            row = {"shape": [m, k, n], "design": design, "kernel_ms": t_kernel,
                   "template_ms": t_template, "plain_ms": t_plain, "library_ms": t_lib,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": nops,
                   "kernel_tflops": nops / t_kernel / 1e9,
                   "library_tflops": nops / t_lib / 1e9}
            log("timing", f"matmul {name} {(m, k, n)} {dt}: kernel ({design}) {t_kernel:.4f} ms "
                          f"({nops / t_kernel / 1e9:.1f} TFLOP/s), template {t_template:.4f} ms "
                          f"({t_template / t_kernel:.2f}x), plain {t_plain:.4f} ms, "
                          f"torch.matmul {t_lib:.4f} ms ({t_kernel / t_lib:.2f}x of it), "
                          f"bound {bound_ms:.4f} ms ({bound_by})")
            res[f"{str(dt).split('.')[1]}_shapes"][name] = row
            del x, w
    res["float32"] = res["float32_shapes"]["qkvo_proj"]
    res["bfloat16"] = res["bfloat16_shapes"]["qkvo_proj"]
    torch.cuda.empty_cache()
    return res


def _device_ms(fn, iters: int, match: str | None) -> float:
    """Device time of one launch: ``fn`` (one kernel launch whose name
    holds ``match``) run ``iters`` times under torch.profiler, the matching
    kernels' device time averaged.  For kernels short enough that the
    host's launch path, not the card, would set an events time.  With
    ``match=None``, the device time of every kernel ``fn`` launches, per
    call (a library call or a composite of several kernels).  A trace
    started late in a process can lose its first device events, so
    ``_fill_trace_start`` fills that window first, and only the kernels
    after it are read."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _fill_trace_start()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in _after_spin(prof)
             if match is None or match in e.name]
    if match is None:
        assert times, "no kernel in the trace"
        return sum(times) / iters / 1e3
    # the trace may drop an event at its edge; never more than one a call
    assert 0 < len(times) <= iters, (match, len(times), iters)
    return sum(times) / len(times) / 1e3


def _fill_trace_start() -> None:
    """What a trace started late in a process may lose first: a spin kernel
    of about 0.2 s (at the H100's ~1.8 GHz) and 8192 short ones; then a
    spin whose end marks where the read events start."""
    torch.cuda._sleep(360_000_000)
    for _ in range(8192):
        torch.cuda._sleep(64)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 16)
    torch.cuda.synchronize()


def _after_spin(prof) -> list:
    """The device kernels of ``prof`` that start after its last spin
    kernel (``_fill_trace_start``), in time order."""
    from torch.autograd import DeviceType

    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [e for e in device if "spin_kernel" in e.name]
    assert marks, "the trace lost the spin kernel"
    start = marks[-1].time_range.end
    return [e for e in device if e.time_range.start >= start]


def _attention_backward_ms(ref, q, k, v, kw) -> float:
    """Device time of the flash kernel's backward at (q, k, v): the plain
    version recomputed from the saved inputs and pulled back
    (``ref.vjp``, what ``FlashAttention.backward`` runs)."""
    do = torch.randn_like(q)
    return _device_ms(lambda: ref.vjp(lambda q, k, v: ref.attention(q, k, v, **kw),
                                      (q, k, v), (True, True, True), do), 5, None)


def _step_timing(ops, ref, dt=torch.bfloat16) -> dict:
    """One ring step at the serving shape cut 4 ways: q, k, v (4, 32, 128,
    128) in ``dt`` and the f32 carry, which the kernel updates in place.
    The kernel (bf16: the wgmma design; float32: the ffma design, the f32
    ring's) and the template design at the same inputs (its C entry, on a
    copy of the carry) by their device time (torch.profiler): a launch
    through the Python wrapper costs more host time than the kernel's
    device time, so CUDA events around wrapper calls time the host; that
    time is reported too.  No tile is skipped, so every (q, k) pair is
    computed; no single PyTorch call computes one step, so there is no
    library time."""
    from repro_torch.kernels import flash_attention as fa

    b, h, blk, d = 4, 32, 128, 128
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(b, h, blk, d, generator=g, device="cuda").to(dt)
               for _ in range(3))
    off = dict(q_offset=3 * blk, kv_offset=blk)
    carry = ops.flash_attention_step(q, k, v, None, impl="kernel", **off)
    design = fa.design(q, k, v, step=True)
    assert design == ("wgmma" if dt == torch.bfloat16 else "ffma"), design
    plain_carry = tuple(t.clone() for t in carry)
    t_carry = tuple(t.clone() for t in carry)
    lib = fa._lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in t_carry), 0,
            fa._DTYPES[q.dtype], b, h, h, blk, blk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], d ** -0.5, 1, 0, off["q_offset"], off["kv_offset"],
            torch.cuda.current_stream().cuda_stream)

    def template():
        err = lib.flash_attention_step(*args)
        if err:
            raise RuntimeError(f"template flash_attention_step: cudaError {err}")
    want = ref.attention_step(q, k, v, plain_carry, **off)
    template()
    for part, got, w in zip("mla", t_carry, want):
        _max_err(got, w, TOL[dt], f"template step {dt} {part}")
    step = lambda: ops.flash_attention_step(q, k, v, carry, impl="kernel", **off)  # noqa: E731
    t_kernel = _device_ms(step, 50, FLASH_DEVICE_KERNEL[design])
    t_template = _device_ms(template, 20, "flash_fwd_kernel")
    t_wrapper = _time_ms(step, 100)
    t_plain = _time_ms(lambda: ref.attention_step(q, k, v, plain_carry, **off), 20)
    nbytes = 3 * q.numel() * q.element_size() + 2 * (2 * b * h * blk + b * h * blk * d) * 4
    nops = 4 * b * h * blk * blk * d
    bound_ms, bound_by = _bound(nbytes, nops, dt)
    log("timing", f"flash_attention_step {(b, h, blk, d)} {dt}: kernel ({design}) "
                  f"{t_kernel:.4f} ms device time, template {t_template:.4f} ms "
                  f"({t_template / t_kernel:.1f}x), one wrapper call {t_wrapper:.4f} ms "
                  f"(host-bound), plain {t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{nbytes} B, {nops} ops); library: none")
    return {"shape": [b, h, blk, d], "dtype": str(dt), "design": design, "kernel_ms": t_kernel,
            "template_ms": t_template, "wrapper_ms": t_wrapper, "plain_ms": t_plain,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": nops}


def _graph_feeds(g, cfg, dtype, seed: int, device="cuda") -> dict:
    """Seeded feeds for a model's prefill graph, made on the card: token
    ids, and weights scaled by their fan-in (the embedding table at 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fan_in = {"embed": 1, "w2": cfg.shared_expert_ff or cfg.d_ff, "we2": cfg.d_ff}
    feeds = {}
    for n in g.nodes:
        if n.kind != "input":
            continue
        if str(np.dtype(n.dtype)) == "int32":
            feeds[n.name] = torch.randint(0, cfg.vocab, n.shape, generator=gen,
                                          device=device, dtype=torch.int32)
        else:
            scale = fan_in.get(n.name, cfg.d_model) ** -0.5
            feeds[n.name] = (torch.randn(n.shape, generator=gen, device=device)
                             * scale).to(dtype)
    return feeds


def _executor_path(cfg, ops) -> dict:
    """llama-7b's prefill graph through ``executor="shard_map"`` on a 1x1
    mesh on the card, in float32 and bf16, against the dense run."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    n_mm = sum(1 for n in g.nodes if n.kind == "einsum" and spmd._as_matmul(n.spec))
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        cold = PlanCache.open(store)
        t0 = time.perf_counter()
        prog.compile(mesh=mesh, executor="shard_map", cache=cold)
        t_cold = time.perf_counter() - t0
        warm = PlanCache.open(store)
        t0 = time.perf_counter()
        run = prog.compile(mesh=mesh, executor="shard_map", cache=warm)
        t_warm = time.perf_counter() - t0
    assert cold.stats["misses"] == 1 and warm.stats["hits"] == 1, (cold.stats, warm.stats)
    dense = prog.compile(mesh_axes=dict(mesh.sizes), device="cuda")
    log("executor", f"llama-7b prefill graph: {len(g.nodes)} nodes, {n_mm} clean "
                    f"contractions; planned cold {t_cold:.4f} s, hit {t_warm:.4f} s; "
                    f"schedule: {run.collectives.summary()}")
    res = {"nodes": len(g.nodes), "n_matmul_nodes": n_mm, "t_plan_cold_s": t_cold,
           "t_plan_hit_s": t_warm}
    # both runs round every product to bf16 after an f32 sum; they may sum
    # in other orders, so allow a few bf16 ulps (2^-8 ≈ 3.9e-3 of the
    # scale) of the largest logit; float32 differs only in its sum order
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    for dt in (torch.float32, torch.bfloat16):
        feeds = _graph_feeds(g, cfg, dt, seed=7)
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            designs = ops.design_counts()
            want = dense(feeds)["logits"]
            torch.cuda.synchronize()
            # the yardstick's products are torch.einsum (cuBLAS), not the kernel
            assert ops.launch_counts()["matmul"] == n_mm, ops.launch_counts()
            prof = _profile(lambda: run(feeds))
        assert launches == {"flash_attention": 1, "flash_attention_step": 0,
                            "matmul": n_mm, "gmm": 0}, launches
        # bf16: every launch of the wgmma design; float32: of the ffma design
        served = dict.fromkeys(("flash_attention", "matmul"),
                               "wgmma" if dt == torch.bfloat16 else "ffma")
        for kernel, design in served.items():
            assert designs[kernel][design] == launches[kernel], designs
        assert got.shape == (4, 512, cfg.vocab_padded) and got.dtype == dt
        assert bool(torch.isfinite(got).all()), "non-finite logits"
        scale = float(want.float().abs().max())
        diff = float((got.float() - want.float()).abs().max())
        if not diff <= tol[dt] * scale:
            raise AssertionError(f"executor {dt}: max|shard_map - dense| = {diff:.3e} "
                                 f"> {tol[dt]} x max|logit| {scale:.3f}")
        name = str(dt).split(".")[1]
        log("executor", f"{name}: launches {launches} by design {designs}; "
                        f"max|shard_map - gspmd| = {diff:.3e} "
                        f"(max|logit| {scale:.3f}, tol {tol[dt]} x that); wall "
                        f"{1e3 * wall:.3f} ms; profiled wall {prof['wall_ms']:.3f} ms, "
                        f"device busy {prof['device_ms']:.3f} ms (idle share "
                        f"{prof['idle_share']:.3f}); device ms by kind {prof['by_kind_ms']}; "
                        f"top {prof['top_kernels_ms'][:4]}")
        res[name] = {"launches": launches, "designs": designs, "max_abs_logit_diff": diff,
                     "max_abs_logit": scale, "tol_rel": tol[dt], "wall_ms": 1e3 * wall,
                     "profile": prof}
        del feeds, got, want
        torch.cuda.empty_cache()
    return res


RING_RANKS = 4


def _sequence_parallel_plan(g, axis: str, r: int):
    """A mesh-mode plan that shards every ``s`` label on ``axis``: no
    product moves anything, and attention rides the ring."""
    from repro_torch.core.decomp import Plan

    plan = Plan(p=r, mode="mesh")
    for n in g.nodes:
        labels = n.spec.all_labels if n.kind == "einsum" else n.labels
        plan.d_by_node[n.nid] = {l: (r if l == "s" else 1) for l in labels}
        plan.axes_by_node[n.nid] = {"s": (axis,)} if "s" in labels else {}
    return plan


RING_DTYPES = ("float32", "bfloat16")
# the ring's logits against the dense run, relative to max|logit|: float32
# differs only in the order of its sums; bf16 as the executor path's bf16
RING_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def ring_rank(rank: int, world: int) -> dict:
    """One gloo rank of the ring path (run by ``launch.mesh.spawn``): the
    plan compiled once, then run in each of ``RING_DTYPES``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    mesh = Mesh({"seq": world}, device="cuda:0")
    run = prog.compile(mesh=mesh, executor="shard_map",
                       plan=_sequence_parallel_plan(prog.graph, "seq", world))
    res = {}
    for name in RING_DTYPES:
        feeds = _graph_feeds(prog.graph, cfg, getattr(torch, name), seed=7)
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out = {"launches": ops.launch_counts(), "designs": ops.design_counts(),
                   "wall_s": wall, "issued": sorted({e[1] for e in run._fn.issued}),
                   "schedule": run.collectives.summary()}
            if rank == 0:  # against the dense run of the same feeds on the card
                want = prog.compile(device="cuda:0")(feeds)["logits"].float()
                out["max_abs_logit"] = float(want.abs().max())
                out["max_abs_logit_diff"] = float((got.float() - want).abs().max())
                out["finite"] = bool(torch.isfinite(got).all())
        res[name] = out
        del feeds, got
        torch.cuda.empty_cache()
    return res


def _ring_path() -> dict:
    from repro_torch.launch.mesh import spawn

    torch.cuda.empty_cache()  # the ranks share this card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn(RING_RANKS, ring_rank, tmpdir=tmp, backend="gloo", timeout=600)
        t_spawn = time.perf_counter() - t0
    res = {"ranks": RING_RANKS, "spawn_s": t_spawn}
    for name in RING_DTYPES:
        per_rank = [r[name] for r in ranks]
        r0 = per_rank[0]
        total = {k: sum(r["launches"][k] for r in per_rank) for k in r0["launches"]}
        for r in per_rank:
            assert r["launches"] == {"flash_attention": 0, "flash_attention_step": RING_RANKS,
                                     "matmul": 8, "gmm": 0}, r["launches"]
            dz = r["designs"]
            if name == "float32":  # every product and every step ffma
                assert dz["matmul"]["ffma"] == 8, dz
                assert dz["flash_attention_step"]["ffma"] == RING_RANKS, dz
            else:  # every step of the wgmma design
                assert dz["flash_attention_step"]["wgmma"] == RING_RANKS, dz
        scale, diff = r0["max_abs_logit"], r0["max_abs_logit_diff"]
        assert r0["finite"], f"non-finite logits on the {name} ring path"
        if not diff <= RING_TOL[name] * scale:
            raise AssertionError(f"ring path {name}: max|ring - dense| = {diff:.3e} > "
                                 f"{RING_TOL[name]} x max|logit| {scale:.3f}")
        log("ring", f"{RING_RANKS} gloo ranks on one card, sequence-parallel llama-7b "
                    f"prefill {name}: launches per rank {r0['launches']} by design "
                    f"{r0['designs']}; collectives issued {r0['issued']}; max|ring - dense| = "
                    f"{diff:.3e} (max|logit| {scale:.3f}, tol {RING_TOL[name]} x that); rank "
                    f"walls {[round(r['wall_s'], 3) for r in per_rank]} s (host-staged gloo, "
                    f"not a speed path)")
        res[name] = {"launches_per_rank": [r["launches"] for r in per_rank],
                     "designs_per_rank": [r["designs"] for r in per_rank],
                     "launches_total": total, "max_abs_logit_diff": diff,
                     "max_abs_logit": scale, "tol_rel": RING_TOL[name],
                     "wall_s": [r["wall_s"] for r in per_rank], "issued": r0["issued"]}
    log("ring", f"both dtypes, all ranks in {t_spawn:.1f} s; schedule: "
                f"{ranks[0]['float32']['schedule']}")
    return res


def _gmm_shapes(qcfg, mcfg) -> dict[str, tuple[int, int, int, int]]:
    """(e, c, k, n) of the expert products on the MoE path: qwen2-moe's w1
    and w2 at b=4, s=512 (T = 2048 tokens) and in a decode step (T = 4),
    and mixtral's w1 at b=4, s=512 (a timing shape: one card does not
    hold mixtral).  c is the dispatch capacity of ``models/moe.py``."""
    from repro_torch.models.moe import _capacity

    e, d, f = qcfg.n_e, qcfg.d_model, qcfg.d_ff
    cp, cd = _capacity(2048, qcfg), _capacity(4, qcfg)
    return {"w1_prefill": (e, cp, d, f), "w2_prefill": (e, cp, f, d),
            "w1_decode": (e, cd, d, f), "w2_decode": (e, cd, f, d),
            "mixtral_w1": (mcfg.n_e, _capacity(2048, mcfg), mcfg.d_model, mcfg.d_ff)}


def _gmm_inputs(e, c, k, n, dt, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(e, c, k, generator=g, device="cuda").to(dt)
    w = (torch.randn(e, k, n, generator=g, device="cuda") * k ** -0.5).to(dt)
    return x, w


def _gmm_parity(qcfg, mcfg, ops, ref) -> dict:
    """The gmm kernel against ``ref.gmm`` on the card, float32 (1e-4) and
    bf16 (3e-2), atol x8 (tests/test_kernels.py)."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(4, 128, 256, 128), (8, 128, 128, 384), (2, 256, 128, 128),  # reference
              (3, 200, 77, 130), (2, 1, 5, 3)]                          # ragged
    path = _gmm_shapes(qcfg, mcfg)
    shapes += list(path.values())
    from repro_torch.kernels import matmul as mm

    out, q_err = [], None
    for shape in shapes:
        for dt in (f32, bf16):
            x, w = _gmm_inputs(*shape, dt)
            want_design = mm.design(x, w)
            got, design = _served_by(ops, "gmm", lambda: ops.gmm(x, w, impl="kernel"))
            assert design == want_design, (shape, dt, design)
            if shape in path.values():  # the path's: f32 ffma, bf16 wgmma
                assert design == ("wgmma" if dt == bf16 else "ffma"), design
            err = _max_err(got, ref.gmm(x, w), MM_TOL[dt], f"gmm {shape} {dt}",
                           atol=8 * MM_TOL[dt])
            out.append({"shape": list(shape), "dtype": str(dt), "design": design,
                        "max_abs_err": err})
            log("gmm-parity", f"{shape} {dt} [{design}]: max|kernel - plain| = {err:.3e} ok")
            if shape == path["w1_prefill"] and dt == bf16:
                q_err = err
    # a weight view out of a stacked (e, units, k, n) tensor (expert stride
    # 2*k*n) and a transposed x (strides (k*c, 1, c)): at c = 150 the x
    # rows are 300 (bf16) or 600 (f32) bytes, which the rule cannot step
    # (the template serves it); at c = 152, 304 or 608 bytes (the wgmma or
    # ffma design reads x M-major)
    for (e, c, k, n), dt in [((5, 150, 96, 70), f32), ((5, 150, 96, 70), bf16),
                             ((5, 152, 96, 72), bf16), ((5, 152, 96, 72), f32)]:
        x, w = _gmm_inputs(e, c, k, n, dt, seed=1)
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        stacked = torch.stack([-w, w], dim=1)
        got, design = _served_by(ops, "gmm", lambda: ops.gmm(xt, stacked[:, 1], impl="kernel"))
        ruled = "wgmma" if dt == bf16 else "ffma"
        assert design == (ruled if c == 152 else "template"), design
        err = _max_err(got, ref.gmm(x, w), MM_TOL[dt], f"gmm strided {dt}",
                       atol=8 * MM_TOL[dt])
        out.append({"shape": [e, c, k, n], "dtype": str(dt), "strided": True,
                    "design": design, "max_abs_err": err})
        log("gmm-parity", f"strided {(e, c, k, n)} {dt} [{design}]: max|kernel - plain| = "
                          f"{err:.3e} ok")
    assert {c["design"] for c in out} == {"wgmma", "ffma", "template"}
    return {"cases": out, "qwen2_prefill_bf16_max_abs_err": q_err}


def _gmm_timing(qcfg, mcfg, ops, ref) -> dict:
    """bf16 at the path's shapes (the wgmma design) and float32 at
    qwen2-moe's w1 (the ffma design, the f32 slice parity's product): the
    kernel, the template design at the same inputs, its plain version, one
    ``torch.bmm`` (TF32 off) and the bound (each input read once, the
    output written once, against 2*e*c*k*n operations)."""
    from repro_torch.kernels import matmul as mm

    res = {}
    shapes = [(name, shape, torch.bfloat16) for name, shape in _gmm_shapes(qcfg, mcfg).items()
              if name != "w2_decode"]  # the same bytes as w1_decode
    shapes.append(("w1_prefill_f32", _gmm_shapes(qcfg, mcfg)["w1_prefill"], torch.float32))
    for name, (e, c, k, n), dt in shapes:
        x, w = _gmm_inputs(e, c, k, n, dt, seed=5)
        item = x.element_size()
        nbytes, nops = (e * c * k + e * k * n + e * c * n) * item, 2 * e * c * k * n
        bound_ms, bound_by = _bound(nbytes, nops, dt)
        slow = name == "mixtral_w1" or dt == torch.float32
        iters = 10 if slow else 50
        design = mm.design(x, w)
        assert design == ("wgmma" if dt == torch.bfloat16 else "ffma"), design
        template, _ = _mm_template(mm, x, w)
        t_kernel = _time_ms(lambda: ops.gmm(x, w, impl="kernel"), iters)
        t_template = _time_ms(template, 3 if slow else 10)
        t_plain = _time_ms(lambda: ref.gmm(x, w), 5)
        t_lib = _time_ms(lambda: torch.bmm(x, w), iters)
        res[name] = {"shape": [e, c, k, n], "dtype": str(dt), "design": design,
                     "kernel_ms": t_kernel, "template_ms": t_template, "plain_ms": t_plain,
                     "library_ms": t_lib, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "ops": nops,
                     "kernel_tflops": nops / t_kernel / 1e9}
        log("timing", f"gmm {name} {(e, c, k, n)} {dt}: kernel ({design}) {t_kernel:.4f} ms "
                      f"({nops / t_kernel / 1e9:.1f} TFLOP/s), template {t_template:.4f} ms "
                      f"({t_template / t_kernel:.1f}x), plain {t_plain:.4f} ms, "
                      f"torch.bmm {t_lib:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                      f"{nbytes} B, {nops} ops)")
        del x, w
    torch.cuda.empty_cache()
    return res


A2A_RANKS = 4


def _expert_parallel_plan(g, axis: str, r: int):
    """A mesh-mode plan that shards the expert label ``e`` on ``axis`` in
    the expert half of the MoE layer (dispatch, the expert products,
    combine); every other node is replicated."""
    from repro_torch.core.decomp import Plan

    plan = Plan(p=r, mode="mesh")
    for n in g.nodes:
        labels = n.spec.all_labels if n.kind == "einsum" else n.labels
        ep = n.kind != "input" and (
            n.op == "moe_combine" or ("e" in labels and "c" in labels))
        plan.d_by_node[n.nid] = {l: (r if ep and l == "e" else 1) for l in labels}
        plan.axes_by_node[n.nid] = {"e": (axis,)} if ep else {}
    return plan


def a2a_rank(rank: int, world: int) -> dict:
    """One gloo rank of the a2a path (run by ``launch.mesh.spawn``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.opaque_stubs import capacity_of, make_stub_opaques

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-moe-a2.7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    make_stub_opaques(capacity_of(g))
    mesh = Mesh({"ep": world}, device="cuda:0")
    run = prog.compile(mesh=mesh, executor="shard_map",
                       plan=_expert_parallel_plan(g, "ep", world))
    feeds = _graph_feeds(g, cfg, torch.float32, seed=8)
    with torch.inference_mode():
        run(feeds)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = run(feeds)["logits"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        designs = ops.design_counts()
        trace = run._fn.schedule.trace
        issued = sorted(run._fn.issued)
        static = sorted((e.nid, e.kind, e.axes, e.elems) for e in trace.events)
        out = {"launches": launches, "designs": designs, "wall_s": wall, "issued": issued,
               "n_matmul_nodes": sum(1 for n in g.nodes if n.kind == "einsum"
                                     and spmd._as_matmul(n.spec)),
               "issued_equals_static": issued == static,
               "rules": sorted(set(trace.rule_by_node.values())),
               "a2a_bytes": {k: v["bytes"] for k, v in trace.by_rule()["a2a"].items()},
               "schedule": run.collectives.summary()}
        if rank == 0:  # against the dense run of the same feeds on the card
            want = prog.compile(device="cuda:0")(feeds)["logits"]
            out["max_abs_logit"] = float(want.abs().max())
            out["max_abs_logit_diff"] = float((got - want).abs().max())
            out["finite"] = bool(torch.isfinite(got).all())
    return out


def _a2a_path() -> dict:
    from repro_torch.launch.mesh import spawn

    torch.cuda.empty_cache()  # the ranks share this card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn(A2A_RANKS, a2a_rank, tmpdir=tmp, backend="gloo", timeout=600)
        t_spawn = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        assert r["issued_equals_static"], "issued collectives differ from the static trace"
        assert "a2a" in r["rules"], r["rules"]
        assert r["launches"] == {"flash_attention": 1, "flash_attention_step": 0,
                                 "matmul": r["n_matmul_nodes"], "gmm": 0}, r["launches"]
        a2a_kinds = [e[1] for e in r["issued"] if e[1] == "all_to_all"]
        assert len(a2a_kinds) >= 4, r["issued"]  # slots + payload, dispatch + combine
        assert r["a2a_bytes"]["all_gather"] < r["a2a_bytes"]["all_to_all"]
    scale, diff = r0["max_abs_logit"], r0["max_abs_logit_diff"]
    assert r0["finite"], "non-finite logits on the a2a path"
    if not diff <= 1e-4 * scale:  # float32: the sums run in other orders
        raise AssertionError(f"a2a path: max|a2a - dense| = {diff:.3e} > 1e-4 x "
                             f"max|logit| {scale:.3f}")
    kinds = sorted({e[1] for e in r0["issued"]})
    log("a2a", f"{A2A_RANKS} gloo ranks on one card, qwen2-moe prefill graph, experts "
               f"on a {A2A_RANKS}-way axis, f32: rules {r0['rules']}; launches per rank "
               f"{r0['launches']} (matmul by design {r0['designs']['matmul']}); each rank "
               f"issued {len(r0['issued'])} collectives "
               f"({kinds}), equal to the static trace; a2a rule bytes {r0['a2a_bytes']}; "
               f"max|a2a - dense| = {diff:.3e} (max|logit| {scale:.3f}); rank walls "
               f"{[round(r['wall_s'], 3) for r in ranks]} s (host-staged gloo, not a "
               f"speed path); all ranks in {t_spawn:.1f} s")
    log("a2a", f"schedule: {r0['schedule']}")
    return {"ranks": A2A_RANKS, "launches_per_rank": [r["launches"] for r in ranks],
            "designs_per_rank": [r["designs"] for r in ranks],
            "issued_per_rank": [len(r["issued"]) for r in ranks],
            "issued_kinds": kinds, "a2a_bytes": r0["a2a_bytes"],
            "max_abs_logit_diff": diff, "max_abs_logit": scale,
            "wall_s": [r["wall_s"] for r in ranks], "spawn_s": t_spawn}


# ---------------------------------------------------------------------------
# 17-19. training: the model stack's train step, and the paper's FFNN
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-4  # float32, the card against the CPU: sums in other orders


def _train_parity(cfg, ops) -> dict:
    """``cfg`` at full width, 2 layers, float32, batch 1, seq 128: the same
    weights and batch on the card (the flash kernel inside its autograd
    Function) and on the CPU (the plain path).  The loss and every
    gradient of ``loss_fn``, then one ``make_train_step`` on each side."""
    from repro_torch.core import tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = tf.init_params(cfg2, seed=2, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg2.vocab, size=(1, 128)).astype(np.int32)
    res: dict = {}
    side: dict = {}
    for dev in ("cuda", "cpu"):
        params = tree.map(lambda t: t.to(dev, copy=True), cpu_params)
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(toks, device=dev)}
        leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
        ops.reset_launch_counts()
        loss, _ = tf.loss_fn(params, batch, cfg2)  # remat on: the reference's default
        grads = torch.autograd.grad(loss, leaves)
        grad_launches = ops.launch_counts()["flash_attention"]
        designs = ops.design_counts()["flash_attention"]
        for p in leaves:
            p.requires_grad_(False)
        step = steps.make_train_step(cfg2)
        ops.reset_launch_counts()
        _, _, met = step(params, adamw_init(params), batch)
        step_launches = ops.launch_counts()["flash_attention"]
        step_designs = ops.design_counts()["flash_attention"]
        side[dev] = {"loss": float(loss.detach()), "grads": [g.float().cpu() for g in grads],
                     "step_loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                     "launches": (grad_launches, step_launches),
                     "designs": {d: designs[d] + step_designs[d] for d in designs}}
        del params, grads, leaves, loss
        torch.cuda.empty_cache()
    gpu, cpu = side["cuda"], side["cpu"]
    # 2 layers x (forward + the remat recompute in the backward); none on the CPU
    assert gpu["launches"] == (4, 4) and cpu["launches"] == (0, 0), (gpu["launches"],
                                                                      cpu["launches"])
    assert gpu["designs"]["ffma"] == 8, gpu["designs"]  # float32 at head dim 128: ffma
    errs = {}
    for what in ("loss", "step_loss", "grad_norm"):
        err = abs(gpu[what] - cpu[what]) / abs(cpu[what])
        log("train-parity", f"{what}: card {gpu[what]:.7f}, CPU {cpu[what]:.7f}, "
                            f"relative error {err:.3e} (limit {TRAIN_TOL})")
        assert err <= TRAIN_TOL, (what, gpu[what], cpu[what])
        errs[what] = err
    leaf_errs = []
    for i, (g, c) in enumerate(zip(gpu["grads"], cpu["grads"])):
        scale = float(c.abs().max())
        err = float((g - c).abs().max())
        leaf_errs.append({"leaf": i, "shape": list(c.shape), "max_abs_err": err,
                          "max_abs_grad": scale, "limit": TRAIN_TOL * scale})
        assert err <= TRAIN_TOL * scale, leaf_errs[-1]
    worst = max(leaf_errs, key=lambda e: e["max_abs_err"] / max(e["max_abs_grad"], 1e-30))
    for e in leaf_errs:
        log("train-parity", f"grad leaf {e['leaf']} {tuple(e['shape'])}: max|card - CPU| "
                            f"{e['max_abs_err']:.3e} (limit {e['limit']:.3e} = "
                            f"{TRAIN_TOL} x max|g| {e['max_abs_grad']:.3e})")
    log("train-parity", f"{cfg.name} width, 2 layers, f32, b=1, s=128: flash launches "
                        f"(value-and-grad, train step) {gpu['launches']}, by design "
                        f"{gpu['designs']}; worst leaf {worst['leaf']} at "
                        f"{worst['max_abs_err'] / worst['max_abs_grad']:.3e} of its max|g|")
    res.update({"rel_err": errs, "grad_leaves": leaf_errs, "launches": gpu["launches"],
                "designs": gpu["designs"], "loss": gpu["loss"], "grad_norm": gpu["grad_norm"]})
    return res


TRAIN_LAYERS = 8  # of llama-7b's 32: all 32 with grads and f32 moments would fill the card
TRAIN_STEPS = 8
ATT_BWD_RANGE = "flash_attention.backward (plain)"
OPT_RANGE = "adamw_update"


def _train_phase(cfg, ops, fa) -> dict:
    """Train ``cfg`` at full width with ``TRAIN_LAYERS`` layers, bf16, batch
    4, seq 512 through ``launch.train.train`` (cosine schedule, a plan-cache
    file and a checkpoint directory under chiprun_out/); restore the
    checkpoint; profile one more warmed step."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models.eingraphs import program_for
    from repro_torch.optim.schedules import cosine_schedule

    cfg8 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("chip_smoke", "train", 512, 4)
    out = ROOT / "chiprun_out"
    ckpt, store = out / "train_ckpt", out / "train_plans.json"
    shutil.rmtree(ckpt, ignore_errors=True)
    store.unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = train_mod.train(cfg8, shape, steps_total=TRAIN_STEPS, ckpt_dir=str(ckpt),
                          plan_cache=str(store), device="cuda", log_every=1)
    wall = time.perf_counter() - t0
    launches, designs = ops.launch_counts(), ops.design_counts()
    peak = torch.cuda.max_memory_allocated()
    params, opt_state = run["params"], run["opt_state"]
    n_params = sum(t.numel() for t in tree.leaves(params))
    per_step = launches["flash_attention"] / TRAIN_STEPS
    # every layer: its forward, and its recompute in the backward (remat)
    assert launches["flash_attention"] == 2 * TRAIN_LAYERS * TRAIN_STEPS, launches
    assert designs["flash_attention"]["wgmma"] == launches["flash_attention"], designs
    assert launches["matmul"] == launches["gmm"] == launches["flash_attention_step"] == 0
    losses = [st["loss"] for st in run["steps"]]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    assert all(np.isfinite([st["grad_norm"] for st in run["steps"]]))
    assert losses[-1] < losses[0], losses
    for st in run["steps"]:
        log("train", f"step {st['step']}: loss {st['loss']:.4f} (ce {st['ce']:.4f}), grad norm "
                     f"{st['grad_norm']:.4f}, lr {st['lr']:.3e}, wall {st['wall_s']:.4f} s")
    # train() planned through the store: the same cell now plans as a hit
    warm = PlanCache.open(str(store))
    program_for(cfg8, shape).compile(mesh_axes={"data": 1, "model": 1}, cache=warm)
    assert warm.stats["hits"] == 1 and warm.stats["misses"] == 0, warm.stats
    # the checkpoint train() wrote at its last step restores bit-equal
    t0 = time.perf_counter()
    restored = CheckpointManager(str(ckpt)).restore_latest((params, opt_state))
    t_restore = time.perf_counter() - t0
    step, (rp, rs), _ = restored
    assert step == TRAIN_STEPS, step
    n_leaves = 0
    for a, b in zip(tree.leaves((rp, rs)), tree.leaves((params, opt_state))):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        n_leaves += 1
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    del restored, rp, rs
    shutil.rmtree(ckpt, ignore_errors=True)  # 4 bytes a parameter, three times over
    torch.cuda.empty_cache()
    log("train", f"{cfg.name} width, {TRAIN_LAYERS} layers, bf16, b=4, s=512: {n_params} "
                 f"params; {TRAIN_STEPS} steps in {wall:.1f} s with the final checkpoint; "
                 f"max_memory_allocated {peak}; flash launches {launches['flash_attention']} "
                 f"({per_step:g} a step) by design {designs['flash_attention']}; checkpoint "
                 f"step {step}, {n_leaves} leaves, {ckpt_bytes} bytes on disk, restored "
                 f"bit-equal in {t_restore:.1f} s")
    # where the time goes: one more step, warmed, timed, profiled
    lr_fn = lambda s: cosine_schedule(s, peak_lr=3e-4, warmup=1, total=TRAIN_STEPS)  # noqa: E731
    step_fn = steps.make_train_step(cfg8, lr_fn=lr_fn)
    hb = train_mod.SyntheticLM(cfg8.vocab, 512, 4, seed=0).global_batch_at(TRAIN_STEPS)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in hb.items()}
    backward, update = fa.FlashAttention.backward, steps.adamw_update

    def tagged(ctx, do):  # the plain backward's kernels, as one profiler range
        with torch.profiler.record_function(ATT_BWD_RANGE):
            return backward(ctx, do)

    def tagged_update(*args, **kw):  # the optimizer's (clip included), as another
        with torch.profiler.record_function(OPT_RANGE):
            return update(*args, **kw)

    fa.FlashAttention.backward = staticmethod(tagged)
    steps.adamw_update = tagged_update
    try:
        prof = _profile(lambda: step_fn(params, opt_state, batch),
                        ranges=(ATT_BWD_RANGE, OPT_RANGE))
    finally:
        fa.FlashAttention.backward = staticmethod(backward)
        steps.adamw_update = update
    bwd_ms, opt_ms = prof["range_ms"][ATT_BWD_RANGE], prof["range_ms"][OPT_RANGE]
    log("profile", f"{cfg.name} {TRAIN_LAYERS}-layer train step: wall {prof['wall_ms']:.3f} ms, "
                   f"device busy {prof['device_ms']:.3f} ms (idle share "
                   f"{prof['idle_share']:.3f}), {prof['kernels']} kernels; device ms by kind "
                   f"{prof['by_kind_ms']}; the plain attention backward {bwd_ms:.3f} ms "
                   f"({bwd_ms / prof['device_ms']:.3f} of device time); AdamW with its clip "
                   f"{opt_ms:.3f} ms ({opt_ms / prof['device_ms']:.3f}); top "
                   f"{prof['top_kernels_ms'][:4]}")
    res = {"layers": TRAIN_LAYERS, "n_params": n_params, "steps": run["steps"],
           "wall_s": wall, "max_memory_allocated": peak, "launches": launches,
           "designs": designs, "flash_launches_per_step": per_step,
           "checkpoint": {"step": step, "leaves": n_leaves, "bytes": ckpt_bytes,
                          "restore_s": t_restore, "bit_equal": True},
           "profile": prof, "attention_backward_ms": bwd_ms,
           "attention_backward_share": bwd_ms / prof["device_ms"],
           "optimizer_ms": opt_ms, "optimizer_share": opt_ms / prof["device_ms"]}
    del params, opt_state, run, batch
    gc.collect()
    torch.cuda.empty_cache()
    res["memory_allocated_after"] = torch.cuda.memory_allocated()
    log("train", f"device memory left allocated after the phase: "
                 f"{res['memory_allocated_after']} bytes")
    return res


FFNN = {"batch": 512, "feats": 597_540, "hidden": 8_192, "labels": 14_588}  # AmazonCat-14K
FFNN_STEPS = 3
FFNN_LR = 2e-7
FFNN_TOL = 1e-4


def _ffnn_graph():
    """benchmarks/bench_ffnn.py's network and loss, built with the port's
    EinGraph: X@W1 -> relu -> @W2 -> - Y -> square -> sum."""
    from repro_torch.core.einsum import EinGraph
    from repro_torch.frontend import Program

    b, f, h, c = (FFNN[k] for k in ("batch", "feats", "hidden", "labels"))
    g = EinGraph("ffnn")
    X = g.input("X", "bf", (b, f))
    W1 = g.input("W1", "fh", (f, h))
    W2 = g.input("W2", "hc", (h, c))
    Y = g.input("Y", "bc", (b, c))
    a1 = g.map("relu", g.einsum("bf,fh->bh", X, W1))
    diff = g.einsum("bc,bc->bc", g.einsum("bh,hc->bc", a1, W2), Y, combine="sub", agg="")
    loss = g.einsum("bc->", g.map("square", diff), combine="id", agg="sum")
    return Program.from_graph(g, {"loss": loss})


def _ffnn_feeds(seed: int = 19) -> dict:
    """Seeded feeds on the card.  X is a binary bag of words (about 600 of
    597,540 features a row) and W1 holds multiples of 2^-10 in [-1/16,
    1/16): every sum in X @ W1 is then exact in float32, whatever its
    order, so the kernel and cuBLAS agree on the sign of every hidden unit.
    (The relu's derivative jumps at 0: one unit whose sign two summation
    orders disagree on would move a row of dW1 by far more than the
    tolerance.)  W2 is Gaussian at 1/sqrt(hidden); Y is multi-hot, about 5
    labels a row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, f, h, c = (FFNN[k] for k in ("batch", "feats", "hidden", "labels"))
    X = (torch.rand((b, f), generator=gen, device="cuda") < 1e-3).to(torch.float32)
    W1 = torch.rand((f, h), generator=gen, device="cuda")
    W1.mul_(128).floor_().sub_(64).mul_(2.0 ** -10)
    W2 = torch.randn((h, c), generator=gen, device="cuda").mul_(h ** -0.5)
    Y = (torch.rand((b, c), generator=gen, device="cuda") < 5 / c).to(torch.float32)
    return {"X": X, "W1": W1, "W2": W2, "Y": Y}


def _ffnn_plain_grads(feeds) -> tuple[float, torch.Tensor, torch.Tensor]:
    """(loss, dW1, dW2) of the plain FFNN through torch.autograd (cuBLAS,
    TF32 off)."""
    W1 = feeds["W1"].detach().requires_grad_()
    W2 = feeds["W2"].detach().requires_grad_()
    loss = torch.sum(torch.square(torch.relu(feeds["X"] @ W1) @ W2 - feeds["Y"]))
    g1, g2 = torch.autograd.grad(loss, [W1, W2])
    return float(loss.detach()), g1, g2


def _ffnn_phase(ops) -> dict:
    """The paper's Experiment 2 at AmazonCat-14K sizes on one card: the
    FFNN's gradient program through ``executor="shard_map"`` on the 1x1
    mesh (planned through a plan-cache file), 3 SGD steps."""
    from repro_torch.analysis import analyze_compiled
    from repro_torch.core import spmd
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch.mesh import Mesh

    prog = _ffnn_graph().grad(wrt=["W1", "W2"])
    g = prog.graph
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        cold = PlanCache.open(store)
        t0 = time.perf_counter()
        prog.compile(mesh=mesh, executor="shard_map", cache=cold)
        t_cold = time.perf_counter() - t0
        warm = PlanCache.open(store)
        t0 = time.perf_counter()
        run = prog.compile(mesh=mesh, executor="shard_map", cache=warm)
        t_warm = time.perf_counter() - t0
    assert cold.stats["misses"] == 1 and warm.stats["hits"] == 1, (cold.stats, warm.stats)
    from repro_torch.core.engine import live_nodes

    live = live_nodes(g, [prog._out[k] for k in prog.output_names])
    n_mm = sum(1 for n in g.nodes
               if n.nid in live and n.kind == "einsum" and spmd._as_matmul(n.spec))
    b, f, h, c = (FFNN[k] for k in ("batch", "feats", "hidden", "labels"))
    flops = 2 * 2 * b * f * h + 3 * 2 * b * h * c  # X@W1 and dW1; p, dW2 and da1
    nbytes = 4 * (b * f + 2 * f * h + 2 * h * c + b * c)  # X, W1 and dW1, W2 and dW2, Y
    bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    feeds = _ffnn_feeds()
    log("ffnn", f"device memory: {mem0} bytes allocated before the feeds, "
                f"{torch.cuda.memory_allocated()} with them")
    log("ffnn", f"gradient graph: {len(g.nodes)} nodes, {len(live)} live, {n_mm} clean "
                f"contractions; planned cold {t_cold:.4f} s, hit {t_warm:.4f} s; plan cost "
                f"{run.plan.cost}; {flops:.4g} FLOP a step, bound {bound_ms:.1f} ms ({bound_by})")
    losses, walls = [], []
    want = None
    for i in range(FFNN_STEPS):
        if i == 0:  # the yardstick first, while nothing else holds a dW1
            want = _ffnn_plain_grads(feeds)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run(feeds)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches, designs = ops.launch_counts(), ops.design_counts()
        assert launches == {"flash_attention": 0, "flash_attention_step": 0,
                            "matmul": n_mm, "gmm": 0}, launches
        assert designs["matmul"]["ffma"] == n_mm, designs
        losses.append(float(out["loss"]))
        if i == 0:
            loss_plain, g1, g2 = want
            log("ffnn", f"device memory with the plain and the executor's gradients: "
                        f"{torch.cuda.memory_allocated()} bytes allocated")
            errs = {}
            for name, got, ref_g in (("W1", out["grad_W1"], g1), ("W2", out["grad_W2"], g2)):
                scale = float(ref_g.abs().max())
                err = max(float((a - b).abs().max())  # in row blocks: no full-size temporary
                          for a, b in zip(got.split(1 << 14), ref_g.split(1 << 14)))
                errs[name] = {"max_abs_err": err, "max_abs_grad": scale,
                              "limit": FFNN_TOL * scale}
                log("ffnn", f"step 0 grad_{name}: max|executor - autograd| {err:.3e} (limit "
                            f"{FFNN_TOL * scale:.3e} = {FFNN_TOL} x max|g| {scale:.3e})")
                assert err <= FFNN_TOL * scale, (name, errs[name])
            loss_err = abs(losses[0] - loss_plain) / loss_plain
            assert loss_err <= FFNN_TOL, (losses[0], loss_plain)
            del want, g1, g2
        with torch.no_grad():  # plain SGD, in place
            feeds["W1"].add_(out["grad_W1"], alpha=-FFNN_LR)
            feeds["W2"].add_(out["grad_W2"], alpha=-FFNN_LR)
        del out
        log("ffnn", f"step {i}: loss {losses[-1]:.6e}, wall {walls[-1]:.4f} s, matmul "
                    f"launches {launches['matmul']} by design {designs['matmul']}")
    assert all(np.isfinite(losses)), losses
    torch.cuda.empty_cache()
    prof = _profile(lambda: run(feeds))
    # every launch is in the trace, or its device time would be short
    assert prof["by_kind_count"]["matmul"] == n_mm, prof["by_kind_count"]
    events_ms = _time_ms(lambda: run(feeds), 2, warmup=0)
    final = float(run(feeds)["loss"])
    assert final < losses[0], (final, losses)
    log("profile", f"FFNN gradient step: wall {prof['wall_ms']:.3f} ms, device busy "
                   f"{prof['device_ms']:.3f} ms (idle share {prof['idle_share']:.3f}, "
                   f"{flops / prof['device_ms'] / 1e9:.2f} TFLOP/s, "
                   f"{prof['device_ms'] / bound_ms:.2f}x the bound; CUDA events "
                   f"{events_ms:.3f} ms), {prof['kernels']} "
                   f"kernels; device ms by kind {prof['by_kind_ms']}; top "
                   f"{prof['top_kernels_ms'][:4]}; loss after {FFNN_STEPS} steps {final:.6e}")
    res = {**FFNN, "nodes": len(g.nodes), "live_nodes": len(live), "t_plan_cold_s": t_cold,
           "t_plan_hit_s": t_warm, "plan_cost": run.plan.cost, "losses": losses + [final],
           "loss_rel_err": loss_err, "grad_errs": errs, "wall_s": walls,
           "matmul_launches_per_step": n_mm, "designs": designs, "flops": flops,
           "bound_ms": bound_ms, "bound_by": bound_by, "profile": prof, "events_ms": events_ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    # one more warmed call, untimed, held against the memory pass in phase 30
    gc.collect()
    torch.cuda.empty_cache()
    out, measured = _allocator_peak(lambda: run(feeds), feeds)
    del out
    res["memory"] = {"static": analyze_compiled(run).memory, "measured": measured}
    del feeds
    torch.cuda.empty_cache()
    return res




# ---------------------------------------------------------------------------
# 20-22. the serving tier: the continuous-batching engine
# ---------------------------------------------------------------------------

# a top-2 logit gap under this share of max|logit| is a near tie (printed)
NEAR_TIE = 2e-2
# the engine's bf16 logits against serve()'s on the same prefix, as a share
# of max|logit|: the two runs round differently (other batch sizes, padded
# and exact prefills) and, with MoE, a near tie in top-k routing can send a
# token to another expert; a request served from another request's context
# differs at the scale of the logits themselves (measured in the same run)
LOGIT_TOL = 5e-2


class _RouteLog:
    """While ``calls`` is a list, every MoE routing of the model stack
    (``models.moe._route``) appends the experts it picked, (tokens, top_k)
    on the CPU.  ``close`` puts the routing function back."""

    def __init__(self):
        from repro_torch.models import moe

        self.calls: list | None = None
        self._moe, self._route = moe, moe._route

        def route(p, xt, cfg):
            topw, tope, aux = self._route(p, xt, cfg)
            if self.calls is not None:
                self.calls.append(tope.detach().cpu())
            return topw, tope, aux

        moe._route = route

    def run(self, fn):
        """``fn()`` and the routings it made, one (tokens, top_k) per layer."""
        self.calls = []
        try:
            return fn(), self.calls
        finally:
            self.calls = None

    def close(self):
        self._moe._route = self._route


def _sequential(cfg, params, prompt: np.ndarray, max_new: int, kv_len: int, device="cuda",
                force: np.ndarray | None = None, routes: _RouteLog | None = None,
                companion: np.ndarray | None = None):
    """One request alone through ``launch.serve``'s steps (the exact-length
    prefill, ``prepare_decode_caches``, decode steps, as ``serve`` runs
    them): the argmax at each position and the logits behind it (float32,
    on the CPU).  Greedy without ``force``; with ``force`` every step is fed
    ``force[i]`` instead (teacher forcing), so position i's logits condition
    on that prefix.  With ``routes``, also the experts each decode step
    picked for the token, (layers, top_k) per position (None at position 0,
    the prefill's).  With ``companion`` (a prompt of the same length) the
    request runs as row 0 of a batch of two, the companion decoding
    greedily beside it: what serving it in a batch does to its rounding."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps

    prefill, decode = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    toks, logs, experts = [], [], [None]
    rows = prompt[None] if companion is None else np.stack([prompt, companion])
    with torch.inference_mode():
        logits, caches = prefill(params, {"tokens": torch.as_tensor(rows, device=device)})
        caches = serve_mod.prepare_decode_caches(cfg, caches, len(prompt), kv_len)
        for i in range(max_new):
            logs.append(logits[0, -1].float().cpu())
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            toks.append(int(tok[0, 0]))
            if force is not None:
                tok[0, 0] = int(force[i])
            if i + 1 < max_new:
                step = lambda: decode(params, tok, caches, len(prompt) + i)  # noqa: E731
                if routes is None:
                    logits, caches = step()
                else:
                    (logits, caches), calls = routes.run(step)
                    experts.append(torch.stack([c[0] for c in calls]))
    return np.asarray(toks, np.int32), logs, experts


def _record_logits(eng, routes: _RouteLog | None = None) -> tuple[dict, dict]:
    """Make ``eng`` copy out, per request, the logits behind each of its
    tokens (float32, on the CPU): its bucketed prefill's at the last real
    token, then its row of every decode step; with ``routes``, also the
    experts each decode step picked for its token, as ``_sequential``.  The
    steps are the engine's own (the registry's prefill entry,
    ``make_paged_serve_step`` and the greedy argmax on the device)."""
    from repro_torch.launch import steps

    rec: dict[int, list] = {}
    rec_experts: dict[int, list] = {}
    reg, decode_base = eng.registry, steps.make_paged_serve_step(eng.cfg)
    order = iter(range(1 << 30))  # admissions come in request order (a FIFO queue)
    get_prefill = reg.prefill

    def prefill(prompt_len, batch=1):
        ent = get_prefill(prompt_len, batch)
        base = getattr(ent, "unrecorded_step", ent.step)
        ent.unrecorded_step = base

        def step(params, batch, last_index):
            logits, caches = base(params, batch, last_index)
            rid = next(order)
            rec[rid], rec_experts[rid] = [logits[0, -1].float().cpu()], [None]
            return logits, caches

        ent.step = step
        return ent

    def decode(params, tokens, caches, tables, pos):
        step = lambda: decode_base(params, tokens, caches, tables, pos)  # noqa: E731
        if routes is None:
            (logits, caches), calls = step(), None
        else:
            (logits, caches), calls = routes.run(step)
        for i, req in enumerate(eng.slots):
            if req is not None:
                rec[req.rid].append(logits[i, -1].float().cpu())
                if calls is not None:
                    rec_experts[req.rid].append(torch.stack([c[i] for c in calls]))
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32), caches

    reg.prefill, eng._decode = prefill, decode
    return rec, rec_experts


def _hold_against_sequential(what: str, got: np.ndarray, got_logits: list,
                             seq_logits: list, other_logits: list, got_experts=None,
                             seq_experts=None, limit: float = LOGIT_TOL) -> dict:
    """The engine's tokens and logits against the sequential run's logits
    on the same prefix (teacher-forced on the engine's tokens), and against
    another request's (``other_logits``: what serving the wrong context
    would look like).  Returns the measured differences and the failures:
    a position where the two runs' logits differ by more than ``limit`` x
    max|logit| (LOGIT_TOL unless a measured rounding baseline sets more), or where the engine's token is not the sequential argmax
    and the top-2 gap is not under twice the measured difference (a flip
    the rounding of the two runs does not explain).  With the experts each
    run's MoE layers picked, the comparison stops at the first position
    where the token went to other experts in some layer (a routing near
    tie: from there on the two runs compute different functions).  Near
    ties, flips and the routing stop are printed."""
    rel, other, flips, failures = [], [], [], []
    stop = len(got)
    for i in range(1, len(got)) if got_experts is not None else ():
        same = (got_experts[i].sort(-1).values == seq_experts[i].sort(-1).values).all(-1)
        if not bool(same.all()):
            layer = int((~same).nonzero()[0, 0])
            log("engine", f"{what}: position {i}: routing differs at layer {layer} (experts "
                          f"{got_experts[i][layer].tolist()} in the engine, "
                          f"{seq_experts[i][layer].tolist()} alone); compared {i} positions")
            stop = i
            break
    for i, (e, q, o) in enumerate(zip(got_logits[:stop], seq_logits, other_logits)):
        scale = float(q.abs().max())
        delta = float((e - q).abs().max())
        top2 = torch.topk(q, 2).values
        gap = float(top2[0] - top2[1])
        rel.append(delta / scale)
        other.append(float((e - o).abs().max()) / scale)
        want = int(torch.argmax(q))
        if gap < NEAR_TIE * scale or int(got[i]) != want:
            log("engine", f"{what}: position {i}: top-2 gap {gap:.4e} ({gap / scale:.2e} of "
                          f"max|logit|), the runs' logits differ by {delta:.4e} "
                          f"({delta / scale:.2e}); token {int(got[i])} "
                          f"{'=' if int(got[i]) == want else '!='} {want}")
        if delta > limit * scale:
            failures.append(f"{what}: position {i}: logits differ by {delta:.4e}, beyond "
                            f"{limit:.3e} x max|logit| {scale:.3f}")
        if int(got[i]) != want:
            flips.append(i)
            if gap >= 2 * delta:
                failures.append(f"{what}: token {i} is {int(got[i])}, the sequential run "
                                f"gives {want} at a top-2 gap {gap:.4e} that the runs' "
                                f"logit difference {delta:.4e} does not explain")
    return {"max_rel_logit_diff": max(rel), "min_rel_diff_to_other_request": min(other),
            "flips": flips, "routing_stop": stop, "held": flips[0] if flips else stop,
            "failures": failures}


def _engine_run(cfg, params, prompts, max_new, *, batch: int, block: int, max_seq: int,
                store: str, ops, device="cuda"):
    """A ``ServingEngine`` on ``device`` over a plan-cache file: every
    request submitted, the launch counters set to 0 just before ``run``
    and read just after, the peak memory of the run."""
    from repro_torch.core.plancache import PlanCache
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(cfg, batch=batch, max_seq=max_seq, block=block, params=params,
                        plan_cache=PlanCache.open(store), device=device)
    for p, n in zip(prompts, max_new):
        eng.submit(p, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, metrics = eng.run()
    launches, designs = ops.launch_counts(), ops.design_counts()
    return eng, res, metrics, {"launches": launches, "designs": designs,
                               "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _engine_phase(cfg, ops, dense_decode: dict, *, slots: int, block: int, max_seq: int,
                  lens: list[int], max_new: int, seed: int = 0, device="cuda",
                  baseline: bool = False) -> dict:
    """``cfg`` at full width and depth (bf16, random weights from ``seed``)
    served by the continuous-batching engine on the card: a first engine
    over a new plan-cache file, then a second over the same file (plans
    with hits only, its run read for the timings).  Checks: each request's
    generation against the sequential serve of that request alone (the
    near-tie rule), flash launches = layers x prefills, gmm launches =
    MoE products x layers x (prefills + decode steps), every bf16 launch of
    the wgmma design, registry compiles = distinct buckets + 1 decode cell.
    Then one engine decode step with every slot live, profiled beside the
    dense serve loop's decode step (phase 5 or 14).  With ``baseline``, the
    logit limit is measured first: each request served alone against the
    same request served as one row of a batch of two (a seeded companion
    prompt of its length beside it), teacher-forced alike; the engine is
    then held to twice the largest such difference where that exceeds
    LOGIT_TOL, and the limit must still tell another context apart."""
    from repro_torch.core import tree
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    news = [max_new] * len(prompts)
    kw = dict(batch=slots, block=block, max_seq=max_seq, ops=ops, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        eng, first, m1, run1 = _engine_run(cfg, params, prompts, news, store=store, **kw)
        buckets = sorted({eng.registry.bucket_len(n) for n in lens})
        stats1 = eng.registry.stats
        assert stats1.compiles == len(buckets) + 1, (stats1, buckets)
        assert stats1.plan_cache_hits == 0, stats1
        del eng
        eng, res, m, run2 = _engine_run(cfg, params, prompts, news, store=store, **kw)
        summary, ttft = m.summary(), [m.ttft_s[r] for r in sorted(m.ttft_s)]
        stats2 = dataclasses.replace(eng.registry.stats)
        assert stats2.compiles == stats2.plan_cache_hits == len(buckets) + 1, stats2
        assert eng.registry.plan_cache.misses == 0, eng.registry.plan_cache.stats
    # the counted runs: what every launch did
    moe_per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    for run, met in ((run1, m1), (run2, m)):
        want = {"flash_attention": _attn_layers(cfg) * met.prefills, "flash_attention_step": 0,
                "matmul": 0,
                "gmm": moe_per_layer * cfg.n_layers * (met.prefills + met.decode_steps)}
        assert run["launches"] == want, (run["launches"], want)
        for kernel in ("flash_attention", "gmm"):
            assert run["designs"][kernel]["wgmma"] == run["launches"][kernel], run["designs"]
    assert m.prefills == m1.prefills == len(lens), (m.prefills, m1.prefills)
    assert m.tokens_generated == len(lens) * max_new, m.tokens_generated
    same = all(np.array_equal(first[r], res[r]) for r in res)
    # the KV pools, and the per-slot recurrent states where the arch has them
    pool_bytes = sum(t.nbytes for t in tree.leaves(eng.caches))
    # a third run that copies out the logits behind every token, and each
    # request against the serve loop's run of it alone on the same prefix
    routes = _RouteLog() if cfg.moe else None
    try:
        rec_eng = ServingEngine(cfg, batch=slots, max_seq=max_seq, block=block, params=params,
                                device=device)
        rec, rec_experts = _record_logits(rec_eng, routes)
        for p in prompts:
            rec_eng.submit(p, max_new)
        rec_res, _ = rec_eng.run()
        del rec_eng
        seq = []
        for rid, p in enumerate(prompts):
            assert ((rec_res[rid] >= 0) & (rec_res[rid] < cfg.vocab_padded)).all()
            assert len(rec[rid]) == max_new, (rid, len(rec[rid]))
            seq.append(_sequential(cfg, params, p, max_new, eng.seq, device,
                                   force=rec_res[rid], routes=routes))
    finally:
        if routes is not None:
            routes.close()
    same_rec = all(np.array_equal(rec_res[r], res[r]) for r in res)
    base_rel, limit = [], LOGIT_TOL
    if baseline:  # what batching alone does to serve()'s logits, in this run
        comp_rng = np.random.default_rng(seed + 1)
        for rid, p in enumerate(prompts):
            comp = comp_rng.integers(0, cfg.vocab, size=p.shape).astype(np.int32)
            _, logs2, _ = _sequential(cfg, params, p, max_new, eng.seq, device,
                                      force=rec_res[rid], companion=comp)
            base_rel.append(max(float((a - b).abs().max() / b.abs().max())
                                for a, b in zip(logs2, seq[rid][1])))
        limit = max(LOGIT_TOL, 2 * max(base_rel))
        log("engine", f"{cfg.name}: serve() of each request in a batch of two against serve() "
                      f"alone, teacher-forced alike: max|logit diff| / max|logit| "
                      f"{[format(x, '.2e') for x in base_rel]}; the engine is held to "
                      f"{limit:.3e} of max|logit|")
    gen, _ = serve_mod.serve(cfg, prompts[0][None], max_new=max_new, params=params,
                             kv_len=eng.seq, device=device)
    free = _sequential(cfg, params, prompts[0], max_new, eng.seq, device)[0]
    assert np.array_equal(gen[0], free), (gen[0], free)  # the helper is serve()'s loop
    held = [_hold_against_sequential(f"{cfg.name} request {rid} (prompt {len(p)})",
                                     rec_res[rid], rec[rid], seq[rid][1],
                                     seq[(rid + 1) % len(prompts)][1],
                                     rec_experts[rid] if routes else None,
                                     seq[rid][2] if routes else None, limit=limit)
            for rid, p in enumerate(prompts)]
    # one engine decode step, every slot live, profiled
    for p in prompts[:slots]:
        eng.submit(p, max_new)
    with torch.inference_mode():
        eng._admit_phase()
        assert all(s is not None for s in eng.slots)
        ops.reset_launch_counts()
        eng._decode_phase()
        step_launches = ops.launch_counts()
        prof = _profile(eng._decode_phase)
    assert step_launches["gmm"] == moe_per_layer * cfg.n_layers, step_launches
    assert step_launches["flash_attention"] == 0, step_launches
    log("engine", f"{cfg.name} bf16, {slots} slots, block {block}, max_seq {max_seq}, "
                  f"{len(lens)} requests (prompts {lens}, buckets {buckets}), {max_new} new "
                  f"each; params made in {t_init:.1f} s")
    log("engine", f"first run (cold plan-cache file): {m1.summary()}; registry {stats1}")
    log("engine", f"second run (the same file): {summary}; registry {stats2}; generations "
                  f"equal to the first run's: {same}, to the logit-recording run's: {same_rec}")
    log("engine", f"TTFT per request (s): {[round(t, 4) for t in ttft]}")
    log("engine", f"launches {run2['launches']}, by design {run2['designs']}; peak memory "
                  f"{run2['max_memory_allocated']} B, pool {pool_bytes} B")
    log("engine", f"against serve() of each request alone, teacher-forced on the engine's "
                  f"tokens: positions compared before the first routing difference "
                  f"{[h['routing_stop'] for h in held]}, tokens before the first flip "
                  f"{[h['held'] for h in held]} of {max_new}; max|logit diff| / max|logit| per request "
                  f"{[format(h['max_rel_logit_diff'], '.2e') for h in held]} (limit "
                  f"{limit:.3e}); against the next request's logits (another context) at "
                  f"least {[format(h['min_rel_diff_to_other_request'], '.2e') for h in held]}")
    failures = [f for h in held for f in h["failures"]]
    assert not failures, failures
    # the limit tells a request served from another context apart
    assert min(h["min_rel_diff_to_other_request"] for h in held) > limit, held
    for name, br in (("engine decode step", prof), ("dense decode step", dense_decode)):
        log("profile", f"{cfg.name} {name}: wall {br['wall_ms']:.3f} ms, device busy "
                       f"{br['device_ms']:.3f} ms (idle share {br['idle_share']:.3f}), "
                       f"{br['kernels']} kernels; device ms by kind {br['by_kind_ms']}")
    out = {"slots": slots, "block": block, "max_seq": max_seq, "prompt_lens": lens,
           "max_new": max_new, "buckets": buckets, "t_init_s": t_init,
           "first_run": m1.summary(), "summary": summary, "ttft_s": ttft,
           "registry_first": dataclasses.asdict(stats1),
           "registry_second": dataclasses.asdict(stats2), "same_as_first_run": same,
           "same_as_recording_run": same_rec,
           "launches": run2["launches"], "designs": run2["designs"],
           "max_memory_allocated": run2["max_memory_allocated"], "pool_bytes": pool_bytes,
           "against_sequential": held, "generations": {r: res[r].tolist() for r in res},
           "batch_baseline_rel": base_rel, "logit_limit_rel": limit,
           "decode_step_launches": step_launches, "profile_decode_step": prof,
           "dense_decode_step": dense_decode,
           # the static verifier over every live bucket (phase 30 reads it)
           "registry_analysis": {
               "/".join(str(k) for k in key): {
                   "findings": [f.format() for f in rep.findings],
                   "peak_bytes": rep.memory["peak_bytes"]}
               for key, rep in eng.registry.analyze().items()}}
    del eng, params
    torch.cuda.empty_cache()
    return out


def _engine_parity(cfg, ops, device="cuda") -> dict:
    """``cfg`` at full width, 2 layers, float32: the engine on the card
    (the flash kernel's ffma design in each bucketed prefill, the gmm
    kernel's ffma design in each MoE product; xlstm launches neither) and
    on the CPU (the plain path), the same weights and requests; tokens
    equal, the logits behind every token (each prefill's and each decode
    step's) within 1e-4 x max|logit|."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = tf.init_params(cfg2, seed=22, device="cpu")
    rng = np.random.default_rng(22)
    lens = rng.integers(32, 129, size=3).tolist()
    prompts = [rng.integers(0, cfg2.vocab, size=(n,)).astype(np.int32) for n in lens]
    max_new = 6
    out = {}
    for dev in (device, "cpu"):
        eng = ServingEngine(cfg2, batch=2, max_seq=144, block=16, params=params, device=dev)
        rec, _ = _record_logits(eng)
        for p in prompts:
            eng.submit(p, max_new)
        ops.reset_launch_counts()
        res, m = eng.run()
        out[dev] = (res, rec, m, ops.launch_counts(), ops.design_counts())
        del eng
    (got, grec, m, launches, designs), (want, wrec, _, cpu_launches, _) = (
        out[device], out["cpu"])
    moe_per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    assert launches == {"flash_attention": _attn_layers(cfg2) * m.prefills,
                        "flash_attention_step": 0,
                        "matmul": 0, "gmm": 2 * moe_per_layer * (m.prefills + m.decode_steps)
                        }, launches
    assert m.prefills == 3 and not any(cpu_launches.values()), cpu_launches
    # float32 at head dim 128: every prefill's flash launch ffma, every MoE product ffma
    assert designs["flash_attention"]["ffma"] == launches["flash_attention"], designs
    assert designs["gmm"]["ffma"] == launches["gmm"], designs
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), (rid, got[rid], want[rid])
        assert len(grec[rid]) == len(wrec[rid]) == max_new, rid
    pairs = [(g, w) for rid in want for g, w in zip(grec[rid], wrec[rid])]
    scale = max(float(w.abs().max()) for _, w in pairs)
    diff = max(float((g - w).abs().max()) for g, w in pairs)
    assert diff <= 1e-4 * scale, (diff, scale)
    log("engine-parity", f"{cfg.name} width, 2 layers, f32, prompts {lens}, {max_new} new, 2 "
                         f"slots: tokens equal on the card and the CPU "
                         f"{[got[r].tolist() for r in sorted(got)]}; max|logit diff| "
                         f"{diff:.3e} (max|logit| {scale:.3f}, limit 1e-4 of it); launches "
                         f"{launches}, flash by design {designs['flash_attention']}, gmm "
                         f"{designs['gmm']}")
    del params
    torch.cuda.empty_cache()
    return {"prompt_lens": lens, "max_new": max_new, "max_abs_logit_diff": diff,
            "max_abs_logit": scale, "launches": launches, "designs": designs,
            "tokens": {r: got[r].tolist() for r in got}}



# ---------------------------------------------------------------------------
# 23-27. the rest of the model zoo: hymba, xlstm, paligemma
# ---------------------------------------------------------------------------

# hymba-1.5b's prefill at b=4, prompt 2048 (GQA 5:1, head dim 64, the
# window of 1024 binds) and paligemma-3b's at b=4, 512 (MQA 8:1, head dim
# 256); paligemma's float32 slice of phase 27 (256 prefix + 64 tokens), and
# its prefill shape in float32 (on no path: a grid of several waves)
HYMBA_PREFILL = (4, 25, 5, 2048, 2048, 64, True, 1024, torch.bfloat16)
PALIGEMMA_PREFILL = (4, 8, 1, 512, 512, 256, True, 0, torch.bfloat16)
PALIGEMMA_F32_SLICE = (1, 8, 1, 320, 320, 256, True, 0, torch.float32)
PALIGEMMA_PREFILL_F32 = PALIGEMMA_PREFILL[:-1] + (torch.float32,)


def _sdpa_call(case, q, k, v):
    """SDPA on the same function as the kernel at ``case``: GQA by
    ``enable_gqa``; a binding window as a boolean mask (causal within the
    window), else ``is_causal``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq, sk, window = case[3], case[4], case[7]
    if window:
        i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        j = torch.arange(sk, device=q.device)[None, :]
        mask = (j <= i) & (j > i - window)
        return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    return lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)


def _kernel_names(fn) -> list[str]:
    """The device kernels one warmed call of ``fn`` launches (names cut to
    90 characters): which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _fill_trace_start()
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:90] for e in _after_spin(prof)})


def _zoo_flash_timing(fa, ops, ref) -> dict:
    """Phase 23: the forward kernel at hymba's and paligemma's prefill
    shapes (bf16, the wgmma design), at paligemma's float32 slice and at its
    prefill shape in float32 (the ffma design): held against its plain
    version, then its device time, SDPA's device time on the same function
    in the same type (its backend named by its kernels), the template's
    device time (its C entry), the plain version's time by events and the
    bound."""
    res = {}
    for name, case in (("hymba", HYMBA_PREFILL), ("paligemma", PALIGEMMA_PREFILL),
                       ("paligemma_f32", PALIGEMMA_F32_SLICE),
                       ("paligemma_f32_b4", PALIGEMMA_PREFILL_F32)):
        q, k, v, kw = _inputs(case, seed=23)
        design = fa.design(q, k, v)
        assert design == _expected_flash_design(case), (name, design)
        kernel = lambda: ops.flash_attention(q, k, v, impl="kernel", **kw)  # noqa: E731
        got, served = _served_by(ops, "flash_attention", kernel)
        assert served == design, (name, served)
        want = ref.attention(q, k, v, **kw)
        err = _max_err(got, want, TOL[case[-1]], f"flash at {name}'s prefill {case[:8]}")
        lib = _sdpa_call(case, q, k, v)
        lib_err = float((lib().float() - want.float()).abs().max())
        del got, want
        template, _ = _flash_template(fa, q, k, v, causal=True, window=case[7])
        t_kernel = _time_ms(kernel, 10)
        t_device = _device_ms(kernel, 10, FLASH_DEVICE_KERNEL[design])
        t_template = _device_ms(template, 5, "flash_fwd_kernel")
        t_plain = _time_ms(lambda: ref.attention(q, k, v, **kw), 3)
        t_lib = _time_ms(lib, 10)
        t_lib_device = _device_ms(lib, 10, None)
        backend = _kernel_names(lib)
        bound_ms, bound_by, nbytes, nops = _attention_bound_ms(case, ref)
        log("zoo-timing", f"flash_attention {name} {case[:8]} {case[-1]}: kernel ({design}) "
                          f"{t_kernel:.4f} ms ({t_device:.4f} ms device time; "
                          f"{t_device / bound_ms:.2f}x the bound, {t_device / t_lib_device:.2f}x "
                          f"sdpa), template {t_template:.4f} ms device time "
                          f"({t_template / t_device:.2f}x the kernel), plain {t_plain:.4f} ms, "
                          f"sdpa {t_lib:.4f} ms "
                          f"({t_lib_device:.4f} ms device time; kernels {backend}; "
                          f"max|sdpa - plain| {lib_err:.3e}), bound {bound_ms:.4f} ms "
                          f"({bound_by}: {nbytes} B, {nops} ops); max|kernel - plain| {err:.3e}")
        res[name] = {"case": str(case), "design": design, "max_abs_err": err,
                     "kernel_ms": t_kernel, "device_ms": t_device,
                     "template_device_ms": t_template, "plain_ms": t_plain,
                     "library_ms": t_lib, "library_device_ms": t_lib_device,
                     "library_kernels": backend, "library_max_abs_err": lib_err,
                     "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": nops}
        del q, k, v
        torch.cuda.empty_cache()
    return res


def _zoo_serve(ops) -> dict:
    """Phases 24-26: hymba-1.5b (prompt 2048, so the window binds in prefill
    and decode runs on the ring buffer), xlstm-125m (prompt 512; no flash
    kernel runs) and paligemma-3b (prompt 512 from tokens, as the
    reference serves it, then one prefill of 256 prefix embeddings and
    256 tokens) at full width and depth, bf16, batch 4, 16 new tokens."""
    from repro_torch.configs import get_config

    out = {}
    for arch, prompt_len, design in (("hymba-1.5b", 2048, "wgmma"),
                                     ("xlstm-125m", 512, "wgmma"),
                                     ("paligemma-3b", 512, "wgmma")):
        cfg = get_config(arch)
        res = _serve_phase(cfg, ops, prompt_len=prompt_len, flash_design=design)
        if not _attn_layers(cfg):
            assert res["launches"]["flash_attention"] == 0, res["launches"]
            log("serve", f"{arch}: no attention layer, so no flash kernel runs; the mLSTM "
                         f"and sLSTM recurrences are plain torch, as in the reference")
        out[arch] = res
    return out


ZOO_SLICE = {"hymba-1.5b": 1280, "xlstm-125m": 512, "paligemma-3b": 64}
ZOO_TOL = 1e-4       # logits (x max|logit|) and the loss (relative), as phase 17
# every gradient leaf, x its max|g|: the attention backward over rows of
# up to 1024 keys subtracts nearly equal f32 sums, so the card's plain path
# alone differs from the CPU by a few 1e-4 at hymba's s = 1280
ZOO_GRAD_TOL = 1e-3


class _PlainAttention:
    """Stands in for ``kernels.ops`` inside ``models.attention`` while it is
    set there: flash attention through its plain version on any device,
    so the card's plain path can be held against the CPU's."""

    def __init__(self, ops):
        self._ops = ops

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def flash_attention(self, *args, **kw):
        return self._ops.flash_attention(*args, impl="ref", **kw)


def _value_and_grads(cfg, cpu_params, batch_np: dict, dev: str, ops, plain: bool = False):
    """Logits of ``forward`` and ``loss_fn`` with every gradient leaf, on
    ``dev`` (``plain``: the card without the flash kernel), with the flash
    launches of the forward and of the loss and its backward."""
    from repro_torch.core import tree
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tf

    params = tree.map(lambda t: t.to(dev, copy=True), cpu_params)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
    if plain:
        attn_mod.ops = _PlainAttention(ops)
    try:
        ops.reset_launch_counts()
        with torch.no_grad():
            logits, _, _ = tf.forward(params, batch["tokens"], cfg,
                                      prefix_embeds=batch.get("prefix_embeds"))
        fwd = ops.launch_counts()["flash_attention"]
        leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
        loss, _ = tf.loss_fn(params, batch, cfg)  # remat on: the reference's default
        grads = torch.autograd.grad(loss, leaves)
    finally:
        attn_mod.ops = ops
    out = {"logits": logits.float().cpu(), "loss": float(loss.detach()),
           "grads": [g.float().cpu() for g in grads],
           "launches": (fwd, ops.launch_counts()["flash_attention"] - fwd),
           "designs": ops.design_counts()["flash_attention"]}
    del params, grads, leaves, loss, logits
    torch.cuda.empty_cache()
    return out


def _rel_errs(got: dict, want: dict) -> tuple[float, list[float]]:
    """max|logit diff| / max|logit|, and per gradient leaf max|diff| / max|g|."""
    scale = float(want["logits"].abs().max())
    lg = float((got["logits"] - want["logits"]).abs().max()) / scale
    return lg, [float((g - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                for g, c in zip(got["grads"], want["grads"])]


def _zoo_slice_parity(ops) -> dict:
    """Phase 27: hymba (s = 1280: the window binds; head dim 64, the ffma
    flash), xlstm (one mLSTM and one sLSTM block, s = 512) and paligemma
    (256 prefix embeddings and 64 tokens; head dim 256, the ffma flash)
    at full width, 2 layers, float32, batch 1: the same weights and inputs
    on the card and on the CPU.  The logits of ``forward`` (ZOO_TOL x
    max|logit|), ``loss_fn`` (ZOO_TOL relative) and every gradient leaf
    (ZOO_GRAD_TOL x its max|g|), all finite.  Beside them, the card's plain
    path (no flash kernel) against the CPU, the rounding the card shows
    without the kernel; and for hymba, the CPU's gradients of the same
    model without its window, against which every attention leaf must
    differ by more than the limit (the limit sees a wrong mask)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    out = {}
    for arch, s in ZOO_SLICE.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
        cpu_params = tf.init_params(cfg, seed=27, device="cpu")
        rng = np.random.default_rng(27)
        toks = rng.integers(0, cfg.vocab, size=(1, s)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.prefix_len:
            batch["prefix_embeds"] = rng.normal(
                size=(1, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        gpu = _value_and_grads(cfg, cpu_params, batch, "cuda", ops)
        plain = _value_and_grads(cfg, cpu_params, batch, "cuda", ops, plain=True)
        cpu = _value_and_grads(cfg, cpu_params, batch, "cpu", ops)
        n_att = _attn_layers(cfg)
        # the forward, then the loss's forward and its remat recompute
        assert gpu["launches"] == (n_att, 2 * n_att), gpu["launches"]
        assert plain["launches"] == cpu["launches"] == (0, 0), (plain["launches"],
                                                                cpu["launches"])
        design = _expected_flash_design((0,) * 5 + (cfg.hd, torch.float32))
        assert gpu["designs"][design] == 3 * n_att, gpu["designs"]
        assert gpu["logits"].shape == (1, s + cfg.prefix_len, cfg.vocab_padded)
        assert bool(torch.isfinite(gpu["logits"]).all())
        lg_err, g_errs = _rel_errs(gpu, cpu)
        lg_plain, g_plain = _rel_errs(plain, cpu)
        loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        names = [f"leaf {i} {tuple(c.shape)}" for i, c in enumerate(cpu["grads"])]
        for name, e, ep in zip(names, g_errs, g_plain):
            log("zoo-parity", f"{arch} grad {name}: max|card - CPU| / max|g| {e:.3e} "
                              f"(card without the kernel {ep:.3e}; limit {ZOO_GRAD_TOL})")
        contrast = None
        if cfg.window:  # the same model without its window: a wrong mask
            nowin = _value_and_grads(dataclasses.replace(cfg, window=0), cpu_params, batch,
                                     "cpu", ops)
            _, c_errs = _rel_errs(nowin, cpu)
            att = [i for i, n in enumerate(names) if len(cpu["grads"][i].shape) == 4]
            contrast = min(c_errs[i] for i in att)
            log("zoo-parity", f"{arch}: without its window, the CPU's attention gradient "
                              f"leaves move by at least {contrast:.3e} of their max|g| "
                              f"(limit {ZOO_GRAD_TOL})")
            assert contrast > ZOO_GRAD_TOL, contrast
        assert all(bool(torch.isfinite(g).all()) for g in gpu["grads"]), arch
        assert lg_err <= ZOO_TOL and loss_err <= ZOO_TOL, (arch, lg_err, loss_err)
        worst = max(range(len(g_errs)), key=lambda i: g_errs[i])
        assert g_errs[worst] <= ZOO_GRAD_TOL, (arch, names[worst], g_errs[worst])
        log("zoo-parity", f"{arch} width, 2 layers ({'+'.join(cfg.block_pattern)}), f32, b=1, "
                          f"s={s}{f' + {cfg.prefix_len} prefix' if cfg.prefix_len else ''}: "
                          f"max|logit diff| / max|logit| {lg_err:.3e} (without the kernel "
                          f"{lg_plain:.3e}; limit {ZOO_TOL}); loss card {gpu['loss']:.7f} CPU "
                          f"{cpu['loss']:.7f} (relative {loss_err:.3e}); {len(g_errs)} gradient "
                          f"leaves, worst {names[worst]} at {g_errs[worst]:.3e} of its max|g| "
                          f"(without the kernel {max(g_plain):.3e} at worst); flash launches "
                          f"(forward, loss and grad) {gpu['launches']}, by design "
                          f"{gpu['designs']}")
        out[arch] = {"seq": s, "prefix_len": cfg.prefix_len, "logit_rel_err": lg_err,
                     "logit_rel_err_plain": lg_plain, "loss": gpu["loss"],
                     "loss_rel_err": loss_err, "grad_rel_errs": g_errs,
                     "grad_rel_errs_plain": g_plain, "window_contrast": contrast,
                     "launches": gpu["launches"], "designs": gpu["designs"],
                     "design": design}
        del cpu_params, gpu, plain, cpu
    return out


def _zoo_executor(ops) -> dict:
    """Phase 27 (cont.): one block period of hymba's prefill EinGraph (b=4,
    s=2048) and of paligemma's (b=4, s=512) in bf16 through
    ``executor="shard_map"`` on the one-rank mesh, against the dense run:
    every clean contraction through the matmul kernel (wgmma), one flash
    launch (wgmma: hymba at head dim 64, paligemma at 256); the scans and the MoE
    stubs are ``models.opaque_stubs``' deterministic stand-ins."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.opaque_stubs import make_stub_opaques

    make_stub_opaques()
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    out = {}
    for arch, seq in (("hymba-1.5b", 2048), ("paligemma-3b", 512)):
        cfg = get_config(arch)
        prog = program_for(cfg, ShapeConfig("serve", "prefill", seq, 4))
        g = prog.graph
        n_mm = sum(1 for n in g.nodes if n.kind == "einsum" and spmd._as_matmul(n.spec))
        run = prog.compile(mesh=mesh, executor="shard_map")
        dense = prog.compile(mesh_axes=dict(mesh.sizes), device="cuda")
        feeds = _graph_feeds(g, cfg, torch.bfloat16, seed=27)
        mm_shapes = sorted({tuple(g.nodes[n.inputs[1]].shape) for n in g.nodes
                            if n.kind == "einsum" and spmd._as_matmul(n.spec)})
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            launches, designs = ops.launch_counts(), ops.design_counts()
            want = dense(feeds)["logits"]
            torch.cuda.synchronize()
            # the yardstick's products are torch.einsum (cuBLAS), not the kernel
            assert ops.launch_counts()["matmul"] == n_mm, ops.launch_counts()
            prof = _profile(lambda: run(feeds))
        flash_design = _expected_flash_design((0,) * 5 + (cfg.hd, torch.bfloat16))
        assert launches == {"flash_attention": 1, "flash_attention_step": 0, "matmul": n_mm,
                            "gmm": 0}, launches
        assert designs["matmul"]["wgmma"] == n_mm, designs
        assert designs["flash_attention"][flash_design] == 1, designs
        assert got.shape == (4, seq, cfg.vocab_padded) and bool(torch.isfinite(got).all())
        scale = float(want.float().abs().max())
        diff = float((got.float() - want.float()).abs().max())
        if not diff <= 1e-2 * scale:  # as the llama-7b executor path's bf16
            raise AssertionError(f"{arch} executor bf16: max|shard_map - dense| = {diff:.3e} "
                                 f"> 1e-2 x max|logit| {scale:.3f}")
        log("zoo-executor", f"{arch} prefill graph (b=4, s={seq}), bf16: {len(g.nodes)} nodes, "
                            f"launches {launches} by design {designs}; weights of the products "
                            f"{mm_shapes}; max|shard_map - dense| {diff:.3e} (max|logit| "
                            f"{scale:.3f}, tol 1e-2 x that); profiled wall {prof['wall_ms']:.3f} "
                            f"ms, device busy {prof['device_ms']:.3f} ms (idle share "
                            f"{prof['idle_share']:.3f}); device ms by kind {prof['by_kind_ms']}")
        out[arch] = {"seq": seq, "launches": launches, "designs": designs,
                     "max_abs_logit_diff": diff, "max_abs_logit": scale,
                     "product_weights": [list(t) for t in mm_shapes], "profile": prof}
        del feeds, got, want, run, dense
        torch.cuda.empty_cache()
    return out


ENGINE_F32_TOL = 1e-4  # x max|logit|: float32 sums in another order (phase 22's)


def _engine_f32_full(cfg, ops, *, slots: int, block: int, max_seq: int, lens: list[int],
                     max_new: int, seed: int = 28) -> dict:
    """Phase 28 (cont.): ``cfg`` at full width and depth in float32 through
    the engine on the card (each bucketed prefill's flash launch of the
    ffma design at head dim 64), every request held against ``serve()`` of
    it alone on the card, teacher-forced on the engine's tokens: logits
    within ENGINE_F32_TOL x max|logit| at every position, no token flip the
    two runs' difference does not explain.  Where bf16 rounding is
    amplified through the layers, this pins the engine's function."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tf.init_params(cfg32, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    eng = ServingEngine(cfg32, batch=slots, max_seq=max_seq, block=block, params=params,
                        device="cuda")
    rec, _ = _record_logits(eng)
    for p in prompts:
        eng.submit(p, max_new)
    ops.reset_launch_counts()
    res, m = eng.run()
    launches, designs = ops.launch_counts(), ops.design_counts()
    assert launches["flash_attention"] == _attn_layers(cfg) * m.prefills, launches
    assert designs["flash_attention"]["ffma"] == launches["flash_attention"], designs
    seq = [_sequential(cfg32, params, p, max_new, eng.seq, "cuda", force=res[rid])
           for rid, p in enumerate(prompts)]
    held = [_hold_against_sequential(f"{cfg.name} f32 request {rid} (prompt {len(p)})",
                                     res[rid], rec[rid], seq[rid][1],
                                     seq[(rid + 1) % len(prompts)][1], limit=ENGINE_F32_TOL)
            for rid, p in enumerate(prompts)]
    failures = [f for h in held for f in h["failures"]]
    assert not failures, failures
    assert min(h["min_rel_diff_to_other_request"] for h in held) > ENGINE_F32_TOL, held
    log("engine", f"{cfg.name} float32, full width and depth, {slots} slots, prompts {lens}, "
                  f"{max_new} new: against serve() of each request alone, max|logit diff| / "
                  f"max|logit| {[format(h['max_rel_logit_diff'], '.2e') for h in held]} (limit "
                  f"{ENGINE_F32_TOL}), token flips {[h['flips'] for h in held]}; launches "
                  f"{launches}, flash by design {designs['flash_attention']}")
    del eng, params
    torch.cuda.empty_cache()
    return {"prompt_lens": lens, "max_new": max_new, "against_sequential": held,
            "launches": launches, "designs": designs,
            "generations": {r: res[r].tolist() for r in res}}


# ---------------------------------------------------------------------------
# 29. the pipelined path
# ---------------------------------------------------------------------------

# (stages, microbatches) -> the reference's static schedule of llama-7b's
# prefill graph (24 nodes, 14 computed; the JAX package, on the CPU): nodes
# a stage, handoff elems, static bubble
PIPE_CASES = {(1, 1): ([14], 0, 0.0), (2, 1): ([7, 7], 16_777_216, 0.5),
              (2, 4): ([7, 7], 16_777_216, 0.2),
              (4, 2): ([1, 6, 6, 1], 100_663_296, 0.6)}
PIPE_DTYPES = ("float32", "bfloat16")
# rank 0's logits against the dense one-card run, of max|logit|: phase 10's
PIPE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def pipeline_rank(rank: int, world: int, cases: list) -> dict:
    """One gloo rank of the pipelined path (run by ``launch.mesh.spawn``,
    or called as rank 0 of 1): each (p, m) of ``cases`` (p = world)
    compiled with ``pipeline=`` and as its baseline, the unpipelined
    compile of the stitched plan on the same mesh; then in each of
    ``PIPE_DTYPES`` the pipelined call with the launch counters set to 0
    just before and read just after, the baseline, and on rank 0 the dense
    run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for
    from repro_torch.pipeline import PipelineSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    mesh = Mesh({"pp": world}, device="cuda:0")
    res = {}
    for p, m in cases:
        run = prog.compile(mesh=mesh, executor="shard_map",
                           pipeline=PipelineSpec(stages=p, microbatches=m))
        base = prog.compile(mesh=mesh, executor="shard_map",
                            plan=run.pipeline_schedule.stitched)
        trace = sorted((e.nid, e.kind, e.axes, e.elems) for e in run.collectives.events)
        for name in PIPE_DTYPES:
            feeds = _graph_feeds(prog.graph, cfg, getattr(torch, name), seed=7)
            with torch.inference_mode():
                run(feeds)  # warm-up
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                got = run(feeds)["logits"]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches, designs = ops.launch_counts(), ops.design_counts()
                issued = sorted(run._fn.issued)
                want = base(feeds)["logits"]
                out = {"launches": launches, "designs": designs, "wall_s": wall,
                       "bit_equal": bool(torch.equal(got, want)),
                       "max_abs_diff_stitched": float((got.float() - want.float()).abs().max()),
                       "issued_is_trace": issued == trace,
                       "issued": sorted({(e[1], e[2]) for e in issued}),
                       "handoff_bytes": sum(e[3] for e in issued if e[2] == ("pp",))
                       * got.element_size(),
                       "shape": tuple(got.shape), "finite": bool(torch.isfinite(got).all())}
                del want
                if rank == 0:  # against the dense run of the same feeds on the card
                    dense = prog.compile(device="cuda:0")(feeds)["logits"].float()
                    out["max_abs_logit"] = float(dense.abs().max())
                    out["max_abs_logit_diff"] = float((got.float() - dense).abs().max())
                    del dense
            res[(p, m, name)] = out
            del feeds, got
            torch.cuda.empty_cache()
    return res


def _pipeline_path(cfg) -> dict:
    """llama-7b's prefill graph through ``compile(pipeline=)`` on 1, 2 and
    4 gloo ranks sharing the card (see the module doc, phase 29)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.eingraphs import program_for
    from repro_torch.pipeline import PipelineSpec, build_pipeline_schedule

    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    assert (len(g.nodes), sum(n.kind != "input" for n in g.nodes)) == (24, 14)
    static = {}
    for (p, m), want in PIPE_CASES.items():
        ps = build_pipeline_schedule(g, PipelineSpec(stages=p, microbatches=m), {"pp": p},
                                     [prog._out["logits"]])
        got = ([len(st.nids) for st in ps.stages], ps.handoff_elems, round(ps.bubble, 12))
        assert got == want, ((p, m), got, want)
        static[f"p{p}m{m}"] = {"stage_nodes": got[0], "handoff_elems": got[1], "bubble": got[2],
                               "bubble_weighted": ps.bubble_weighted}
    torch.cuda.empty_cache()  # the ranks share this card
    t0 = time.perf_counter()
    ranks = {1: [pipeline_rank(0, 1, [(1, 1)])]}  # one rank: no process group
    for p in (2, 4):
        with tempfile.TemporaryDirectory() as tmp:
            ranks[p] = spawn(p, pipeline_rank, [c for c in PIPE_CASES if c[0] == p],
                             tmpdir=tmp, backend="gloo", timeout=400)
    t_all = time.perf_counter() - t0
    designs_total = {k: dict.fromkeys(DESIGNS_ALL, 0) for k in ("flash_attention", "matmul")}
    res = {"static": static, "wall_s": t_all}
    for (p, m), (sizes, elems, bubble) in PIPE_CASES.items():
        for name in PIPE_DTYPES:
            per_rank = [r[(p, m, name)] for r in ranks[p]]
            design = "wgmma" if name == "bfloat16" else "ffma"
            for r in per_rank:
                assert r["bit_equal"], ((p, m, name), r["max_abs_diff_stitched"])
                assert r["launches"] == {"flash_attention": m, "flash_attention_step": 0,
                                         "matmul": 8 * m, "gmm": 0}, r["launches"]
                for k, total in designs_total.items():
                    assert r["designs"][k][design] == r["launches"][k], r["designs"]
                    for d, n in r["designs"][k].items():
                        total[d] += n
                assert r["issued_is_trace"], ((p, m, name), r["issued"])
                assert r["issued"] == ([] if p == 1 else [("ppermute", ("pp",))]), r["issued"]
                assert r["finite"] and r["shape"] == (4, 512, cfg.vocab_padded), r["shape"]
            r0 = per_rank[0]
            scale, diff = r0["max_abs_logit"], r0["max_abs_logit_diff"]
            if not diff <= PIPE_TOL[name] * scale:
                raise AssertionError(f"pipelined p={p} m={m} {name}: max|pipelined - dense| = "
                                     f"{diff:.3e} > {PIPE_TOL[name]} x max|logit| {scale:.3f}")
            log("pipeline", f"p={p} m={m} {name}: stages of {sizes} nodes, bubble {bubble}, "
                            f"handoff {elems} elems, {r0['handoff_bytes']} B a call; every rank's "
                            f"logits bit-equal to the stitched plan's compile; launches per rank "
                            f"{r0['launches']} by design {r0['designs']}; collectives issued "
                            f"{r0['issued']} (the static trace); max|pipelined - dense| = "
                            f"{diff:.3e} (max|logit| {scale:.3f}, tol {PIPE_TOL[name]} x that); "
                            f"rank walls {[round(r['wall_s'], 4) for r in per_rank]} s "
                            f"(host-staged gloo, not a speed path)")
            res[f"p{p}m{m}_{name}"] = {
                "launches_per_rank": [r["launches"] for r in per_rank],
                "designs_per_rank": [r["designs"] for r in per_rank],
                "bit_equal_per_rank": [r["bit_equal"] for r in per_rank],
                "issued": r0["issued"], "handoff_bytes": r0["handoff_bytes"],
                "max_abs_logit_diff": diff, "max_abs_logit": scale, "tol_rel": PIPE_TOL[name],
                "wall_s": [r["wall_s"] for r in per_rank]}
    for k, total in designs_total.items():
        assert total["template"] == 0, designs_total
    res["designs_total"] = designs_total
    log("pipeline", f"every case, every rank in {t_all:.1f} s; launches by design {designs_total}")
    return res


# ---------------------------------------------------------------------------
# 30. the static verifier on the card
# ---------------------------------------------------------------------------

# the memory pass's peak against the allocator's: the reference's own band
# against XLA (tests/test_analysis.py)
MEM_BAND = 0.10


def _retyped(g, dtype):
    """A copy of EinGraph ``g`` whose float nodes are typed ``dtype``."""
    from repro_torch.core.einsum import EinGraph

    out = EinGraph(g.name)
    out.nodes = [dataclasses.replace(n, dtype=dtype) if np.dtype(n.dtype).kind == "f" else n
                 for n in g.nodes]
    return out


def _allocator_peak(call, feeds) -> tuple:
    """``call()``'s result, and the allocator's peak over it less what was
    allocated before it and is not one of ``feeds``: what the call adds to
    its arguments, plus the arguments, as the memory pass counts."""
    feed_bytes = sum(t.nbytes for t in feeds.values() if torch.is_tensor(t) and t.is_cuda)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, {"measured_bytes": peak - (before - feed_bytes), "feed_bytes": feed_bytes,
                 "allocated_before": before, "max_memory_allocated": peak}


def _memory_check(what: str, static: dict, measured: dict) -> dict:
    ratio = static["peak_bytes"] / measured["measured_bytes"]
    log("analysis", f"{what}: memory pass peak {static['peak_bytes']} B (args "
                    f"{static['args_bytes']}, outputs {static['out_bytes']}, at node "
                    f"{static['peak_pos']}); allocator {measured['measured_bytes']} B "
                    f"(max_memory_allocated {measured['max_memory_allocated']} less "
                    f"{measured['allocated_before'] - measured['feed_bytes']} B held before the "
                    f"call that are not its feeds); static / measured {ratio:.4f}")
    assert abs(ratio - 1.0) <= MEM_BAND, (what, ratio, static["peak_bytes"], measured)
    return {"static_peak_bytes": static["peak_bytes"], "static_args_bytes": static["args_bytes"],
            "static_out_bytes": static["out_bytes"], "static_peak_pos": static["peak_pos"],
            **measured, "ratio": ratio}


def _analysis_phase(cfg, results: dict) -> dict:
    """(a) the analysis CLI over the zoo in a subprocess; (b) the memory
    pass against the allocator; (c) phase 20's registry (see the module
    doc, phase 30)."""
    import os

    from repro_torch.analysis import analyze_compiled
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.frontend import Program
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = out_dir / "analysis_zoo.json"
    snippet = ("import sys, torch\n"
               "from repro_torch.analysis.__main__ import main\n"
               f"rc = main(['--json', {str(report)!r}])\n"
               "print('cuda initialised:', torch.cuda.is_initialized(), '; jax imported:',\n"
               "      'jax' in sys.modules)\n"
               "assert not torch.cuda.is_initialized() and 'jax' not in sys.modules\n"
               "sys.exit(rc)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", snippet], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
                          cwd=str(ROOT))
    t_cli = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(report.read_text())
    assert payload["n_errors"] == payload["n_warnings"] == 0 and len(payload["cells"]) == 11
    tail = proc.stdout.strip().splitlines()[-3:]
    log("analysis", f"python -m repro_torch.analysis over the reduced zoo: exit 0 in {t_cli:.1f} s, "
                    f"{len(payload['cells'])} cells, 0 findings; {tail}")
    res = {"cli": {"exit": proc.returncode, "cells": len(payload["cells"]), "wall_s": t_cli,
                   "tail": tail}}

    # (b) phase 10's one-rank compile of llama-7b's prefill graph, f32 and bf16
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    memory = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        p = prog if dt == torch.float32 else Program.from_graph(_retyped(prog.graph, dt),
                                                                prog._out)
        run = p.compile(mesh=mesh, executor="shard_map")
        feeds = _graph_feeds(prog.graph, cfg, dt, seed=7)
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            gc.collect()
            logits, measured = _allocator_peak(lambda: run(feeds), feeds)
        del logits
        memory[f"executor_{name}"] = _memory_check(
            f"llama-7b prefill graph, one rank, {name}", analyze_compiled(run).memory, measured)
        del feeds, run
        torch.cuda.empty_cache()
    memory["ffnn"] = _memory_check("FFNN gradient program at AmazonCat-14K sizes, float32",
                                   results["ffnn"]["memory"]["static"],
                                   results["ffnn"]["memory"]["measured"])
    res["memory"] = memory

    # (c) the engine's bucket registry of phase 20 (analysed there, before it went)
    for phase in ("engine", "engine_moe", "engine_hymba"):
        cells = results[phase]["registry_analysis"]
        assert cells and all(c["findings"] == [] for c in cells.values()), (phase, cells)
        log("analysis", f"{phase}'s BucketRegistry.analyze(): {len(cells)} live buckets, all "
                        f"clean; peak bytes a bucket "
                        f"{ {k: c['peak_bytes'] for k, c in cells.items()} }")
    res["registry"] = {phase: results[phase]["registry_analysis"]
                       for phase in ("engine", "engine_moe", "engine_hymba")}
    return res


if __name__ == "__main__":
    sys.exit(main())
