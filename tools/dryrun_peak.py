"""What one rank holds at the dry run's peak of live bytes, by the op and
the source line that made each buffer.

    python tools/dryrun_peak.py --arch qwen2-moe-a2.7b --shape train_4k [--multi-pod] [--top 15]

Builds one cell of ``repro_torch.launch.dryrun`` (the production mesh, its
plan's policy, meta blocks, no card) and measures its step with
``launch.costs.StepCosts`` tagging buffers: each is tagged with the op
that made it and the innermost line of the port's model code on the
stack, and the buffers live when the peak was last raised are summed by
tag.  Prints the cell's ``per_device_gb`` and policy, then the largest
tags: GB, buffers, op, line.  A cell is run at its own length (the dry
run's trip extension of long recurrent cells is not applied).
"""
from __future__ import annotations

import argparse
import collections
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    mesh = dryrun.production_mesh(args.multi_pod)
    step, step_args, _, _, policy = dryrun.build_cell(get_config(args.arch),
                                                      SHAPES[args.shape], mesh)
    costs = dryrun.measure_step(step, step_args, tag_buffers=True)
    mesh_name = "x".join(str(s) for s in mesh.sizes.values())
    print(f"{args.arch} {args.shape} {mesh_name}: per_device_gb "
          f"{costs['memory']['peak'] / 1e9}, policy "
          f"{ {k: list(v) for k, v in policy.label_axes.items()} }")
    total, count = collections.Counter(), collections.Counter()
    for tag, nbytes in costs["peak_buffers"]:
        total[tag] += nbytes
        count[tag] += 1
    print(f"live at the peak: {sum(total.values()) / 1e9:.3f} GB")
    for (name, line), nbytes in total.most_common(args.top):
        print(f"{nbytes / 1e9:10.3f} GB  x{count[(name, line)]:<4d} {str(name):24s} {line}")


if __name__ == "__main__":
    main()
