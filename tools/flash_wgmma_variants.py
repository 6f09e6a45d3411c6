"""Variants of the bf16 "wgmma" flash-attention forward on the card.

    python3 tools/flash_wgmma_variants.py [--against DIR]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``,
each with one piece of the wgmma design changed or removed, one nvcc per
variant, all started together, into ``build/wgmma_variants/``.  Then it
times each variant by device time (torch.profiler) at paligemma-3b's
prefill (4, 8, 512, 256) and at batch 1, at llama-7b's (4, 32, 512, 128)
and one engine prefill (1, 32, 512, 128), and at hymba-1.5b's (4, 25,
2048, 64) with its window of 1024, all bf16 and causal, and prints the
card's name and power limit.  The variants:

- ``shipped``: the design as it is (at head dim 256 each block pairs a
  heavy 64-row q chunk with a light one; at 64 and 128 a block takes the
  two chunks of one 128-row q tile, heaviest tiles first);
- ``unpaired``: head dim 256 takes the two chunks of one q tile too;
- ``paired_all``: every head dim pairs heavy with light;
- ``rescale_skip``: the accumulator's rescale by alpha skipped where
  neither of a thread's two rows moved its max (x 1 changes no bit);
- ``no_s`` / ``no_pv``: at head dim 256, the S = Q K^T or the P V
  products removed; ``no_kv_reload``: only the first two K/V tiles
  loaded, the ring's later stages reused as they are (wrong results:
  they time what remains);
- ``against``: with ``--against DIR``, the ``flash_attention.cu`` in DIR
  (with its own headers: another checkout's ``csrc``, such as the parent
  commit's from ``git archive``), built and timed the same way where its
  wgmma entry takes the shape.

Every variant that keeps the results is held to ``ref.attention`` at the
bf16 tolerance.  Needs a card and nvcc; numbers go to
``chiprun_out/wgmma_variants.json`` too.
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
OUT = ROOT / "build" / "wgmma_variants"
PAIRED = "constexpr bool PAIRED = !STEP && D == 256;"
RESCALE = """#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * c + 2 * i] *= alpha[i];
          o[4 * c + 2 * i + 1] *= alpha[i];
        }
"""
VARIANTS = {  # name: [(text of the shipped source, its replacement)], each text once
    "shipped": [],
    "unpaired": [(PAIRED, "constexpr bool PAIRED = false;")],
    "paired_all": [(PAIRED, "constexpr bool PAIRED = !STEP;")],
    "rescale_skip": [(RESCALE, "      if (alpha[0] != 1.f || alpha[1] != 1.f) {\n" + RESCALE
                      + "      }\n")],
    "no_s": [("hopper::wgmma_m64n64_ss<0, 0>(sc, dq, dk, kk > 0);",
              "if (kk == 0) for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;")],
    "no_pv": [("      wgmma_pv<D>(o, pa[kk], dv);\n", "")],
    "no_kv_reload": [("        hopper::mbar_expect_tx(&full[s], 2 * L::KTILE);\n",
                      "        if (t >= W_STAGES) { hopper::mbar_arrive(&full[s]); ++t; continue; }\n"
                      "        hopper::mbar_expect_tx(&full[s], 2 * L::KTILE);\n")],
}
KEEPS_RESULTS = ("shipped", "unpaired", "paired_all", "rescale_skip", "against")
CASES = [  # (b, hq, hkv, sq, sk, d, causal, window, dtype)
    cs.PALIGEMMA_PREFILL,
    (1, 8, 1, 512, 512, 256, True, 0, torch.bfloat16),
    cs.SLICE,
    cs.ENGINE_PREFILL + (torch.bfloat16,),
    cs.HYMBA_PREFILL,
]


def build(name: str, source: str, include: Path = CSRC) -> ctypes.CDLL:
    for old, new in VARIANTS.get(name, []):
        assert source.count(old) == 1, (name, old)
        source = source.replace(old, new)
    src = OUT / f"{name}.cu"
    src.write_text(source)
    lib = OUT / f"{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(include), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    for k in cs._ptxas_kernels(proc.stderr + proc.stdout):
        if k["kernel"] == "flash_wgmma_kernel<256,0>":
            print(f"{name}: {k}", flush=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_wgmma_variants: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    source = (CSRC / "flash_attention.cu").read_text()
    jobs = [(name, source, CSRC) for name in VARIANTS]
    if "--against" in sys.argv:
        other = Path(sys.argv[sys.argv.index("--against") + 1]).resolve()
        jobs.append(("against", (other / "flash_attention.cu").read_text(), other))
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip([j[0] for j in jobs], pool.map(lambda j: build(*j), jobs)))
    shipped = fa._lib()
    stream = torch.cuda.current_stream().cuda_stream
    res: dict = {}
    for case in CASES:
        q, k, v, kw = cs._inputs(case, seed=23)
        b, hq, sq, d = q.shape
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, case[2], sq,
                case[4], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                d ** -0.5, 1, case[7], kw["q_offset"], 0, stream)
        want = ref.attention(q, k, v, **kw)
        for name, lib in libs.items():
            if name.startswith("no_") and d != 256:
                continue
            fn = lib.flash_attention_wgmma_fwd
            fn.argtypes = shipped.flash_attention_wgmma_fwd.argtypes
            if fn(*args) != 0:  # another source's rule may refuse the shape
                assert name == "against", name
                res.setdefault(name, {})[str(case[:8])] = "refused"
                print(f"forward {case[:8]} bf16 causal, {name}: refused", flush=True)
                continue
            if name in KEEPS_RESULTS:
                cs._max_err(o, want, cs.TOL[torch.bfloat16], f"variant {name} at {case[:8]}")
            ms = [cs._device_ms(lambda: fn(*args), 20, "flash_wgmma_kernel") for _ in range(2)]
            res.setdefault(name, {})[str(case[:8])] = ms
            print(f"forward {case[:8]} bf16 causal, {name}: {[round(1e3 * t, 1) for t in ms]} "
                  f"us device time", flush=True)
        del q, k, v, o, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wgmma_variants.json").write_text(json.dumps({"device": smi, "ms": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
