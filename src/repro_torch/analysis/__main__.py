"""``python -m repro_torch.analysis``: static verification of the model zoo.

Backend-free end to end: graph construction (frontend tracing), §8 DP
planning, schedule lowering, and all four passes are pure Python — the
subprocess test asserts that CUDA is never initialized and that neither
jax nor the reference package is imported.

Examples::

    python -m repro_torch.analysis                      # all families, 3 modes
    python -m repro_torch.analysis --families llama-7b --modes decode \
        --mesh data=2,model=4 --max-hbm 2000000000 --json report.json
    python -m repro_torch.analysis --list-codes
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.findings import CODES
from repro_torch.analysis.runner import analyze_program

#: the bench families (benchmarks/bench_spmd.py); paged decode is only
#: built for the serving families (benchmarks/bench_serve.py)
FAMILIES = ["llama-7b", "mixtral-8x7b", "xlstm-125m", "hymba-1.5b"]
PAGED_FAMILIES = ["llama-7b", "xlstm-125m", "hymba-1.5b"]
MODES = ["prefill", "decode", "paged"]

#: reduced-config cell shapes, mirroring the benches: prefill 32x4
#: (bench_spmd), decode/paged 40x4 with 8-row KV blocks (bench_serve)
PREFILL_SEQ, PREFILL_BATCH = 32, 4
DECODE_SEQ, DECODE_BATCH = 40, 4
KV_BLOCK = 8


def _parse_mesh(text: str) -> dict[str, int]:
    axes: dict[str, int] = {}
    for part in text.split(","):
        if not part.strip():
            continue
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    if not axes:
        raise argparse.ArgumentTypeError(f"empty mesh spec {text!r}")
    return axes


def _cell_program(family: str, mode: str):
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.models.eingraphs import program_for

    cfg = reduced(get_config(family))
    if mode == "prefill":
        shape = ShapeConfig("analysis", "prefill", PREFILL_SEQ,
                            PREFILL_BATCH)
        return program_for(cfg, shape)
    shape = ShapeConfig("analysis", "decode", DECODE_SEQ, DECODE_BATCH)
    return program_for(cfg, shape,
                       kv_block=KV_BLOCK if mode == "paged" else 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Backend-free static verifier for the model zoo "
                    "(graph / plan / schedule / memory passes).")
    ap.add_argument("--families", default="all",
                    help=f"comma list or 'all' ({', '.join(FAMILIES)})")
    ap.add_argument("--modes", default="all",
                    help=f"comma list or 'all' ({', '.join(MODES)})")
    ap.add_argument("--mesh", type=_parse_mesh, default="data=2,model=4",
                    help="mesh shape, e.g. data=2,model=4 (device count is "
                         "the product)")
    ap.add_argument("--max-hbm", type=int, default=None,
                    help="per-device HBM bound in bytes (RA301/RA302)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="analyze the unfused repartition lowering")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="graph-wide overlap window (0 = serial issue "
                         "order; default 1, the executor default)")
    ap.add_argument("--pp", type=int, default=0,
                    help="pipeline stages: adds a pp=<n> mesh axis and "
                         "runs the RA4xx pipeline pass (0 = off)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="microbatches for the pipeline pass (clamped to "
                         "1 for graphs whose rows couple across the "
                         "batch, e.g. MoE capacity routing)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the full report to this path")
    ap.add_argument("--list-codes", action="store_true",
                    help="print the RA error-code index and exit")
    args = ap.parse_args(argv)

    if isinstance(args.mesh, str):
        args.mesh = _parse_mesh(args.mesh)

    if args.list_codes:
        for code, (sev, desc) in sorted(CODES.items()):
            print(f"{code}  {sev:7s}  {desc}")
        return 0

    fams = FAMILIES if args.families == "all" else \
        [f.strip() for f in args.families.split(",") if f.strip()]
    modes = MODES if args.modes == "all" else \
        [m.strip() for m in args.modes.split(",") if m.strip()]
    for m in modes:
        if m not in MODES:
            ap.error(f"unknown mode {m!r} (choose from {MODES})")

    reports = []
    n_errors = n_warnings = 0
    for family in fams:
        for mode in modes:
            if mode == "paged" and family not in PAGED_FAMILIES:
                continue
            prog = _cell_program(family, mode)
            mesh = dict(args.mesh)
            pipeline = None
            if args.pp:
                from repro_torch.pipeline import PipelineSpec

                pipeline = PipelineSpec(stages=args.pp,
                                        microbatches=args.microbatches)
                mesh = {pipeline.axis: args.pp, **mesh}
            report = analyze_program(
                prog, mesh, max_hbm=args.max_hbm,
                fuse=not args.no_fuse, lookahead=args.lookahead,
                pipeline=pipeline,
                meta={"family": family, "mode": mode,
                      "mesh": ",".join(f"{k}={v}"
                                       for k, v in mesh.items())})
            reports.append(report)
            n_errors += len(report.errors)
            n_warnings += len(report.warnings)
            mem = report.memory.get("peak_bytes")
            peak = f" peak={mem:,}B/dev" if mem is not None else ""
            status = "OK" if not report.findings else \
                ("FAIL" if report.has_errors else "WARN")
            print(f"ANALYZE {family:14s} {mode:8s} "
                  f"mesh={report.meta['mesh']:18s} "
                  f"{len(report.errors)}E/{len(report.warnings)}W "
                  f"{status}{peak}", flush=True)
            for f in report.findings:
                print(f"    {f.format()}", flush=True)

    print(f"analyzed {len(reports)} cell(s): {n_errors} error(s), "
          f"{n_warnings} warning(s)", flush=True)
    if args.json_path:
        payload = {"mesh": args.mesh, "n_errors": n_errors,
                   "n_warnings": n_warnings,
                   "cells": [r.to_json() for r in reports]}
        with open(args.json_path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        print(f"report written to {args.json_path}", flush=True)
    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
