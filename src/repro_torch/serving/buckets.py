"""Shape-bucket registry: one live compiled handle per serving shape cell.

Continuous batching wants to admit arbitrary-length prompts without
replanning per length.  The registry quantizes prompt lengths into
buckets and keeps exactly one ``CompiledProgram`` (plus its projected
``ShardingPolicy`` and step function) per
``(arch, kind, bucket_len, batch[, kv_block])`` cell, resolved through the
canonical plan cache — the *second* process (or the second bucket that is
structurally isomorphic) skips the §8 DP entirely.  The step functions run
the model stack eagerly (``launch/steps.py``).

Bucket policy: pure-attention, non-MoE archs round prompt lengths up to a
power of two (pad tokens sit behind the causal mask, so real positions
are unaffected); recurrent archs (ssm/xlstm blocks) and MoE archs get
exact-length buckets — a recurrent scan folds pad tokens into its final
state and MoE capacity couples rows, so padding would change real
outputs, not just waste FLOPs.

The registry plans on the one-device mesh (``launch.serve.ONE_DEVICE_MESH``)
and runs on one device; a mesh of more than one rank needs the DTensor
placements of ROADMAP Queue 1 item 4 and raises.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plancache import PlanCache
from repro_torch.launch import steps
from repro_torch.launch.serve import ONE_DEVICE_MESH
from repro_torch.models.common import resolve_device
from repro_torch.models.eingraphs import program_for


def pad_free(cfg) -> bool:
    """True iff right-padding a prompt cannot change real-token outputs:
    every block is causal attention (pad keys are masked) and routing does
    not couple rows (no MoE)."""
    return all(b == "attn" for b in cfg.block_pattern) and not cfg.moe


def bucket_len(cfg, prompt_len: int, *, mode: str = "auto",
               min_bucket: int = 8) -> int:
    """Quantized prefill length for ``prompt_len`` under the policy."""
    if mode not in ("auto", "pow2", "exact"):
        raise ValueError(f"bucket mode {mode!r}")
    if mode == "exact" or (mode == "auto" and not pad_free(cfg)):
        return int(prompt_len)
    return max(min_bucket, 1 << (int(prompt_len) - 1).bit_length())


@dataclass
class BucketEntry:
    """One shape cell's live handle: the planned program, its policy
    projection, and the step function serving requests."""

    key: tuple
    canonical_key: str
    compiled: Any
    policy: Any
    step: Callable
    plan_time_s: float
    cache_hit: bool
    hits: int = 0


@dataclass
class RegistryStats:
    compiles: int = 0
    lookups: int = 0
    plan_cache_hits: int = 0
    plan_time_s: float = 0.0


def _mesh_axes(mesh) -> dict[str, int]:
    """``{axis: size}`` of ``mesh`` (a ``launch.mesh.Mesh``, a dict of axis
    sizes, or None for the one-device mesh); more than one rank raises."""
    if mesh is None:
        return dict(ONE_DEVICE_MESH)
    axes = dict(getattr(mesh, "sizes", mesh))
    if math.prod(axes.values()) > 1:
        raise NotImplementedError(
            f"BucketRegistry: a mesh of {math.prod(axes.values())} ranks "
            f"({axes}) needs parameter and cache placements (DTensor) — the "
            "DTensor slice of the port (ROADMAP Queue 1 item 4), not ported "
            "yet")
    return axes


class BucketRegistry:
    """Per-(arch, shape-cell) compiled-handle cache over the plan cache.

    ``device`` (default: the card) is where the compiled programs run;
    ``executor="shard_map"`` compiles them for the explicit-collective
    executor on the one-rank mesh, as ``launch.serve.serve`` does."""

    def __init__(self, cfg, mesh=None, *, plan_cache=None,
                 executor: str = "gspmd", bucket: str = "auto",
                 min_bucket: int = 8, device=None):
        self.cfg = cfg
        self.axes = _mesh_axes(mesh)
        self.device = resolve_device(device)
        self.executor = executor
        self.bucket = bucket
        self.min_bucket = min_bucket
        coerced = PlanCache.coerce(plan_cache)
        # explicit None test: an empty PlanCache is falsy (len 0), and a
        # caller-shared cache must not be silently replaced
        self.plan_cache = PlanCache() if coerced is None else coerced
        self.stats = RegistryStats()
        self._entries: dict[tuple, BucketEntry] = {}

    # -- shape-cell resolution ------------------------------------------------

    def bucket_len(self, prompt_len: int) -> int:
        return bucket_len(self.cfg, prompt_len, mode=self.bucket,
                          min_bucket=self.min_bucket)

    def prefill(self, prompt_len: int, batch: int = 1) -> BucketEntry:
        """The prefill cell covering ``prompt_len`` (bucketed)."""
        seq = self.bucket_len(prompt_len)
        return self._get("prefill", seq, batch, 0)

    def decode(self, seq: int, batch: int, kv_block: int) -> BucketEntry:
        """The persistent paged-decode cell for a batch bucket."""
        if seq % kv_block:
            raise ValueError(f"decode seq {seq} not a multiple of the "
                             f"kv block {kv_block}")
        return self._get("decode", seq, batch, kv_block)

    # -- internals ------------------------------------------------------------

    def _get(self, kind: str, seq: int, batch: int,
             kv_block: int) -> BucketEntry:
        self.stats.lookups += 1
        key = (self.cfg.name, kind, seq, batch, kv_block)
        ent = self._entries.get(key)
        if ent is not None:
            ent.hits += 1
            return ent

        shape = ShapeConfig("serve", kind, seq, batch)
        prog = program_for(self.cfg, shape, kv_block=kv_block)
        h0, m0 = self.plan_cache.hits, self.plan_cache.misses
        t0 = time.perf_counter()
        mesh = None
        if self.executor == "shard_map":
            from repro_torch.launch.mesh import Mesh

            mesh = Mesh(self.axes, device=self.device)
        compiled = prog.compile(mesh_axes=dict(self.axes),
                                cache=self.plan_cache, mesh=mesh,
                                executor=self.executor, device=self.device)
        plan_t = time.perf_counter() - t0
        hit = (self.plan_cache.hits > h0 and self.plan_cache.misses == m0)
        policy = compiled.policy()
        ent = BucketEntry(key=key, canonical_key=compiled.canonical_key,
                          compiled=compiled, policy=policy,
                          step=self._make_step(kind),
                          plan_time_s=plan_t, cache_hit=hit)
        self._entries[key] = ent
        self.stats.compiles += 1
        self.stats.plan_time_s += plan_t
        if hit:
            self.stats.plan_cache_hits += 1
        return ent

    # -- static verification --------------------------------------------------

    def analyze(self, max_hbm: int | None = None) -> dict:
        """Statically re-verify every live bucket cell
        (``repro_torch.analysis``): each entry's CompiledProgram is checked
        with its own plan and donation set under this registry's mesh
        shape — graph, plan, schedule, and memory passes, all
        backend-free, so it is safe to call on a loaded serving host.
        Returns ``{bucket key: Report}``; callers gate on
        ``report.has_errors``."""
        from repro_torch.analysis import analyze_compiled

        return {
            key: analyze_compiled(
                ent.compiled, max_hbm=max_hbm, mesh_axes=dict(self.axes),
                meta={"bucket": "/".join(str(k) for k in key)})
            for key, ent in sorted(self._entries.items())}

    def _make_step(self, kind: str) -> Callable:
        if kind == "prefill":
            return steps.make_bucket_prefill_step(self.cfg)
        base = steps.make_paged_serve_step(self.cfg)

        def decode_step(params, tokens, caches, tables, pos):
            logits, caches = base(params, tokens, caches, tables, pos)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            return tok, caches

        return decode_step
