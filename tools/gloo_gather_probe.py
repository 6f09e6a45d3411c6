"""Where a checkpoint save's time goes on 2 gloo ranks sharing one card.

    python tools/gloo_gather_probe.py [--gib 4]

Each rank holds ``--gib`` GiB on the card (a 2-layer llama-7b-width
float32 tree of params and AdamW moments is 8 GB: 4 GB a rank on
{data: 2}) and times, a barrier apart: the copy of its block to host
memory (pageable, then into a pinned buffer, with the pinning's own
cost), ``dist.gather`` of the block to rank 0 in one piece, in 512 MiB and
in 64 MiB pieces (what ``checkpoint/ckpt.py`` does one leaf at a time),
and a host copy of the block as rank 0's assembly of a leaf does.  Each
rank prints one dict of seconds.  Needs one card.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402


def rank_fn(rank: int, world: int, nbytes: int) -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh

    Mesh({"data": world}, device="cuda:0")
    out = {}
    x = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    h = x.to("cpu")
    out["d2h_pageable_s"] = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    p = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out["pin_alloc_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p.copy_(x)
    torch.cuda.synchronize()
    out["d2h_pinned_s"] = time.perf_counter() - t0
    for chunk in (nbytes, 512 << 20, 64 << 20):
        dist.barrier()
        t0 = time.perf_counter()
        for a in range(0, nbytes, chunk):
            blk = h[a:a + chunk]
            got = [torch.empty_like(blk) for _ in range(world)] if rank == 0 else None
            dist.gather(blk, got, dst=0)
        out[f"gather_{chunk >> 20}MiB_pieces_s"] = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    w = torch.empty(2 * nbytes, dtype=torch.uint8)
    w[:nbytes] = h
    out["host_copy_s"] = time.perf_counter() - t0
    out["threads"] = torch.get_num_threads()
    return out


def main(argv=None) -> None:
    from repro_torch.launch.mesh import spawn

    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=4.0, help="GiB a rank")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        for rank, r in enumerate(spawn(2, rank_fn, int(args.gib * (1 << 30)), tmpdir=tmp,
                                       timeout=600)):
            print(rank, r, flush=True)


if __name__ == "__main__":
    main()
