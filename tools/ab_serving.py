"""Phase 5's llama-7b prefill and phase 20's engine TTFT of two checkouts,
in turns, on one card.

    python tools/ab_serving.py A_ROOT B_ROOT [--out FILE]

Each run is a subprocess that imports the ``chip_smoke`` of one checkout
(and that checkout's ``src``) and calls its ``_serve_phase`` (phase 5:
llama-7b bf16 at full size, b=4, prompt 512, 16 new) and ``_engine_phase``
(phase 20: 4 slots, 8 requests of 192-512 tokens, 16 new each, seed 0).
Runs go A, B, B, A, so that a drift of the card's clocks shows on both
sides.  Each prints its numbers as one JSON line; the script prints every
run's line, then one JSON object of the least of each side's two runs:
the serve call's ``t_prefill_s``, the profiled prefill's wall and device
milliseconds, and the engine's TTFT per request, mean TTFT, tok/s and
prefill seconds (its second, warm run); the most of tok/s.  Each checkout builds its kernels into its own
``build/``.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json, sys
import numpy as np
import torch
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import ops
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
cfg = get_config("llama-7b")
serve = cs._serve_phase(cfg, ops)
lens = np.random.default_rng(0).integers(192, 513, size=8).tolist()
eng = cs._engine_phase(cfg, ops, serve["profile"], slots=4, block=16,
                       max_seq=528, lens=lens, max_new=16)
pf = serve["profile"]["prefill"]
print("AB " + json.dumps({"t_prefill_s": serve["t_prefill_s"],
                          "prefill_wall_ms": pf["wall_ms"], "prefill_device_ms": pf["device_ms"],
                          "ttft_s": eng["ttft_s"],
                          "mean_ttft_s": sum(eng["ttft_s"]) / len(eng["ttft_s"]),
                          "engine_tok_per_s": eng["summary"]["tok_per_s"],
                          "engine_t_prefill_s": eng["summary"]["t_prefill_s"]}))
"""


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN, str(root)], cwd=root,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")][-1]
    return json.loads(line[3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    runs = []
    for side in "ABBA":
        got = run((args.a if side == "A" else args.b).resolve())
        got["side"] = side
        runs.append(got)
        print(json.dumps(got), flush=True)
    best = {}
    for side in "AB":
        mine = [r for r in runs if r["side"] == side]
        best[side] = {k: min(r[k] for r in mine) for k in
                      ("t_prefill_s", "prefill_wall_ms", "prefill_device_ms", "mean_ttft_s",
                       "engine_t_prefill_s")}
        best[side]["engine_tok_per_s"] = max(r["engine_tok_per_s"] for r in mine)
        best[side]["ttft_s"] = min(mine, key=lambda r: r["mean_ttft_s"])["ttft_s"]
    print(json.dumps(best))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"runs": runs, "best": best}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
