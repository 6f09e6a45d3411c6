"""Ablations of the float32 "ffma" flash-attention design on the card.

    python3 tools/flash_ffma_variants.py

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``,
each with one piece of the ffma design removed or changed, one nvcc per
variant, all started together, into ``build/ffma_variants/``.  Then it
times each variant by device time (torch.profiler) at the forward's
(4, 32, 512, 128) and (1, 32, 512, 128) float32 causal, at head dim 256
with MQA 8:1 at paligemma-3b's float32 slice (1, 8, 320, 256) and its
prefill shape (4, 8, 512, 256), and at the ring step's (4, 32, 128, 128),
and prints the card's name and power limit.  The variants:

- ``shipped``: the design as it is;
- ``no_s`` / ``no_pv``: the S = Q K^T or the P V loop removed (wrong
  results: they time what remains);
- ``no_copies``: the K and V refills after the first tile removed (wrong
  results);
- ``floor``: all three removed; ``floor_no_q``, ``floor_no_first``,
  ``floor_no_combine`` and ``floor_no_split``: the floor without Q's load,
  without the first tile's K and V copies, without the combine of a
  cluster's two blocks, or unsplit (wrong results);
- ``no_combine``: the cluster's second block's partial dropped (wrong
  results: the combine's cost);
- ``rows_4``: 4 q rows a thread and 256 threads a block at head dim 64
  and 128, instead of 8 and 128;
- ``no_split``: at head dim 256, one block a q tile whatever the grid,
  instead of a cluster of two sharing its key tiles where the grid has
  fewer q tiles than SMs;
- ``rows_64``: 64-row q tiles at head dim 256, 4 rows a thread, so 256
  threads and 208 KB a block, unsplit (40 blocks at the float32 slice);
- ``q_unroll_4``: 4 of Q's float4 loads in flight at head dim 256, not all;
- ``v_late``: the first V tile's copies issued once the first K tile has
  landed, not beside them;
- ``heaviest_first`` / ``paired``: the q tiles heaviest first, or heavy
  paired with light, whatever the grid (the shipped design pairs them only
  where the whole grid is resident at once).

Every variant that keeps the results is held to ``ref.attention`` at the
float32 tolerance.  Needs a card and nvcc; numbers go to
``chiprun_out/ffma_variants.json`` too.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ffma_variants"
ORDER = "p.one_wave && z >= half"
NO_S = [("for (int d0 = 0; d0 < D; d0 += 8) {", "for (int d0 = 0; d0 < 0; d0 += 8) {")]
NO_PV = [("for (int j0 = 0; j0 < F_BK; j0 += 8) {", "for (int j0 = 0; j0 < 0; j0 += 8) {")]
NO_COPIES = [("if (next < n_kt) ffma_load_k<D>(Ks, kg, p.k_ss, next * F_BK, p.sk);", ""),
             ("if (next < n_kt) ffma_load_v<D>(Vs, vg, p.v_ss, next * F_BK, p.sk);", "")]
FLOOR = NO_S + NO_PV + NO_COPIES
NO_SPLIT = [("bool SPLIT = D == 256;", "bool SPLIT = false;")]
COMBINE = "if (p.split) {\n      // block 1 stores its partial"
NO_COMBINE = [(COMBINE, COMBINE.replace("p.split", "false")),
              ('asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");', "")]
V_FIRST = ("  if (kt < n_kt) ffma_load_v<D>(Vs, vg, p.v_ss, kt * F_BK, p.sk);\n"
           "  hopper::cp_async_commit();\n")
K_LANDED = "  hopper::cp_async_wait<1>();  // this thread's copies of the first K tile landed\n"
VARIANTS = {  # name: [(text of the shipped source, its replacement)], each text once
    "shipped": [],
    "no_s": NO_S,
    "no_pv": NO_PV,
    "no_copies": NO_COPIES,
    "floor": FLOOR,
    "floor_no_q": FLOOR + [("if (q0 + row < p.sq)", "if (false)")],
    "floor_no_first": FLOOR + [
        ("  if (kt < n_kt) ffma_load_k<D>(Ks, kg, p.k_ss, kt * F_BK, p.sk);", ""),
        ("  if (kt < n_kt) ffma_load_v<D>(Vs, vg, p.v_ss, kt * F_BK, p.sk);", "")],
    "floor_no_combine": FLOOR + NO_COMBINE,
    "floor_no_split": FLOOR + NO_SPLIT,
    "no_combine": NO_COMBINE,
    "rows_4": [("int RT = D == 256 ? 4 : 8;", "int RT = 4;")],
    "no_split": NO_SPLIT,
    "rows_64": [("int BQ = D == 256 ? 32 : 64;", "int BQ = 64;")] + NO_SPLIT,
    "q_unroll_4": [("int Q_UNROLL = D == 256 ? 16 : 4;", "int Q_UNROLL = 4;")],
    "v_late": [(V_FIRST, ""),
               (K_LANDED, "  hopper::cp_async_wait<0>();\n  __syncthreads();\n" + V_FIRST)],
    "heaviest_first": [(ORDER, "false && z >= half")],
    "paired": [(ORDER, "z >= half")],
}
KEEPS_RESULTS = ("shipped", "rows_4", "no_split", "rows_64", "q_unroll_4", "v_late",
                 "heaviest_first", "paired")

def build(name: str, source: str) -> ctypes.CDLL:
    for old, new in VARIANTS[name]:
        assert source.count(old) == 1, (name, old)
        source = source.replace(old, new)
    src = OUT / f"{name}.cu"
    src.write_text(source)
    lib = OUT / f"{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ffma_variants: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    source = (CSRC / "flash_attention.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, source), VARIANTS)))
    shipped = fa._lib()
    stream = torch.cuda.current_stream().cuda_stream
    res: dict = {}
    for case in [(4, 32, 32, 512, 512, 128, True, 0, torch.float32),
                 (1, 32, 32, 512, 512, 128, True, 0, torch.float32),
                 cs.PALIGEMMA_F32_SLICE, cs.PALIGEMMA_PREFILL_F32]:
        q, k, v, kw = cs._inputs(case, seed=3)
        b, hq, sq, d = q.shape
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, case[2], sq,
                case[4], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                d ** -0.5, 1, 0, kw["q_offset"], 0, stream)
        want = ref.attention(q, k, v, **kw)
        for name, lib in libs.items():
            fn = lib.flash_attention_ffma_fwd
            fn.argtypes = shipped.flash_attention_ffma_fwd.argtypes
            assert fn(*args) == 0, name
            if name in KEEPS_RESULTS:
                cs._max_err(o, want, cs.TOL[torch.float32], f"variant {name} at {case[:6]}")
            ms = [cs._device_ms(lambda: fn(*args), 20, "flash_ffma_kernel") for _ in range(2)]
            res.setdefault(name, {})[f"forward {case[:6]}"] = ms
            print(f"forward {case[:6]} f32 causal, {name}: {[round(1e3 * t, 1) for t in ms]} us "
                  f"device time", flush=True)
        del q, k, v, o, want
    b, h, blk, d = 4, 32, 128, 128
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(b, h, blk, d, generator=g, device="cuda") for _ in range(3))
    off = dict(q_offset=3 * blk, kv_offset=blk)
    carry = ref.attention_step(q, k, v, None, **off)
    for name, lib in libs.items():
        fn = lib.flash_attention_step_ffma
        fn.argtypes = shipped.flash_attention_step_ffma.argtypes
        c = tuple(t.clone() for t in carry)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in c), 0, b, h,
                h, blk, blk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], d ** -0.5, 1,
                0, off["q_offset"], off["kv_offset"], stream)
        ms = [cs._device_ms(lambda: fn(*args), 50, "flash_ffma_kernel") for _ in range(2)]
        res[name]["step (4, 32, 128, 128)"] = ms
        print(f"step (4, 32, 128, 128) f32, {name}: {[round(1e3 * t, 2) for t in ms]} us "
              f"device time", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ffma_variants.json").write_text(json.dumps({"device": smi, "ms": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
