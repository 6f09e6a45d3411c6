"""Persistent plan cache: in-memory LRU + optional on-disk JSON store.

Every entry is a ``Plan`` stored in *canonical labels* (core/canon.py) under
the key ``plan_key(graph, p, mesh, cost mode, ...)``, so a plan computed for
one graph is a cache **hit** for every isomorphic graph — same structure up
to label renaming, (label, bound) permutation, and commutative operand
order.  On lookup the canonical plan is rewritten back into the caller's
labels via the caller graph's own label maps; the returned object is a fresh
``Plan``, never a reference into the cache.

Two layers:

  * an in-memory LRU (``capacity`` entries) that every lookup goes through;
  * an optional JSON file (``path=``) reusing ``Plan.to_json``/``from_json``
    so serving/training jobs warm-start their planner across restarts
    (``launch/serve.py --plan-cache``, ``launch/train.py --plan-cache``).

The cache also hosts the §8.4 *path memo*: ``eindecomp`` memoizes the
per-path DP on canonical path signatures, so repeated isomorphic layers
inside one graph (or across graphs in one process) skip the DP entirely.
Path-memo entries are in-memory only — they are an intra-process
optimization, cheap to recompute and awkward to version on disk.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import warnings
from collections import OrderedDict

from repro_torch.core import canon
from repro_torch.core import decomp as _decomp
from repro_torch.core.decomp import Plan
from repro_torch.core.einsum import EinGraph

_STORE_VERSION = 1


class PlanCache:
    """LRU plan cache with an optional JSON backing file.

    Parameters
    ----------
    capacity:
        Max in-memory entries; least-recently-used plans are evicted first.
        Evicted entries that were loaded from / saved to disk are still
        rewritten on the next ``save``, so the file only ever grows by use.
    path:
        Optional JSON store.  If the file exists it is loaded eagerly
        (warm start); with ``autosave=True`` (default) every ``insert``
        rewrites it atomically.  Per-insert persistence is deliberate:
        inserts happen once per *unique* (graph, p, mesh, mode) — planner
        events, not request events — and a ~ms file write next to a ~100ms
        DP run buys crash durability.  Jobs that bulk-plan many cells can
        pass ``autosave=False`` and call ``save()`` once at the end.
    """

    def __init__(self, capacity: int = 256, path: str | None = None, *,
                 autosave: bool = True):
        self.capacity = max(1, int(capacity))  # a 0-capacity LRU cannot hold
        # even the entry being served; clamp rather than crash mid-lookup
        self.path = path
        self.autosave = autosave
        self._mem: OrderedDict[str, Plan] = OrderedDict()  # canonical labels
        self._path_memo: dict = {}
        self._lock = threading.Lock()
        # json-form entries known to be on disk (superset of evicted ones)
        # + the store mtime we last observed, so save() only re-reads the
        # file when another process has written it in between.
        self._disk_entries: dict = {}
        self._disk_mtime: float | None = None
        self.hits = 0
        self.misses = 0
        self.path_hits = 0
        self.path_misses = 0
        if path and os.path.exists(path):
            self.load(path)

    @classmethod
    def open(cls, path: str, capacity: int = 256) -> "PlanCache":
        """A disk-backed cache: loads ``path`` if present, persists on every
        insert.  The one-liner serving/training entry points use."""
        return cls(capacity=capacity, path=path, autosave=True)

    @classmethod
    def coerce(cls, cache: "PlanCache | str | os.PathLike | None") -> "PlanCache | None":
        """Accept what entry points take: a PlanCache, a store path (str or
        PathLike, opened disk-backed), or None (caching disabled)."""
        if isinstance(cache, (str, os.PathLike)):
            return cls.open(os.fspath(cache))
        return cache

    # -- keying --------------------------------------------------------------

    def key_for(self, g: EinGraph, p: int, **kw) -> str:
        """The cache key ``eindecomp`` arguments map to (see canon.plan_key)."""
        return canon.plan_key(g, p, **kw)

    # -- core API ------------------------------------------------------------

    def lookup(self, g: EinGraph, p: int, **kw) -> Plan | None:
        """Return a plan for ``g`` translated into its labels, or None.

        ``kw`` is forwarded to ``canon.plan_key`` (mesh_axes, cost_mode,
        offpath_repart, algo) — the same kwargs the plan was inserted under.
        """
        key = self.key_for(g, p, **kw)
        with self._lock:
            plan = self._mem.get(key)
            if plan is None:
                # revive an entry evicted from the LRU (or beyond capacity
                # at load): its JSON is still held in _disk_entries, one
                # deserialization away — never re-run the DP for it
                pj = self._disk_entries.get(key)
                if pj is not None:
                    try:
                        plan = Plan.from_json(pj)
                    except (KeyError, TypeError, ValueError):
                        plan = None
                if plan is not None:
                    self._mem[key] = plan
            if plan is None:
                self.misses += 1
                return None
            self._mem.move_to_end(key)
            self._evict_overflow()  # after move_to_end: key is MRU, kept
            self.hits += 1
        return canon.plan_from_canonical(g, plan)

    def insert(self, g: EinGraph, p: int, plan: Plan, **kw) -> str:
        """Store ``plan`` (computed for ``g``) under its canonical key and
        return that key.  The plan is translated to canonical labels first,
        so the stored entry is graph-name- and label-agnostic."""
        key = self.key_for(g, p, **kw)
        stored = canon.plan_to_canonical(g, plan)
        with self._lock:
            self._mem[key] = stored
            self._mem.move_to_end(key)
            self._evict_overflow()
        if self.path and self.autosave:
            self.save()
        return key

    def _evict_overflow(self) -> None:
        """Trim the LRU (lock held).  Disk-backed caches spill evictions to
        _disk_entries so a not-yet-persisted plan is never lost and a later
        lookup revives it without re-running the DP; memory-only caches keep
        strict LRU bounds (capacity is their only memory limit)."""
        while len(self._mem) > self.capacity:
            ek, ev = self._mem.popitem(last=False)
            if self.path:
                self._disk_entries[ek] = ev.to_json()

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._path_memo.clear()

    @property
    def stats(self) -> dict:
        return {"entries": len(self._mem), "hits": self.hits,
                "misses": self.misses, "path_hits": self.path_hits,
                "path_misses": self.path_misses}

    # -- on-disk JSON store (reuses Plan.to_json / Plan.from_json) -----------

    def save(self, path: str | None = None) -> str:
        """Atomically write the store as JSON.

        Entries already on disk are preserved and merged under the in-memory
        ones (memory wins on key conflicts), so LRU eviction — or a
        small-capacity cache pointed at a large store — never deletes plans
        from the file: the store only ever grows by use.  The read-merge-
        write runs under an advisory ``flock`` on ``<path>.lock``, so
        concurrent jobs sharing one store don't lose each other's inserts;
        the file is only re-read when its mtime shows another writer."""
        path = path or self.path
        if not path:
            raise ValueError("PlanCache.save: no path configured")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path + ".lock", "w") as lockf:
            try:
                import fcntl

                fcntl.flock(lockf, fcntl.LOCK_EX)
            except (ImportError, OSError):  # non-POSIX: best effort
                pass
            try:
                mtime = os.stat(path).st_mtime_ns
            except OSError:
                mtime = None
            if mtime is not None and mtime != self._disk_mtime:
                try:
                    with open(path) as f:
                        prev = json.load(f)
                    if (isinstance(prev, dict)
                            and prev.get("version") == _STORE_VERSION):
                        self._disk_entries.update(prev.get("entries", {}))
                except (OSError, json.JSONDecodeError):
                    pass  # corrupt store: overwrite with a valid one
            with self._lock:
                self._disk_entries.update(
                    {k: v.to_json() for k, v in self._mem.items()})
                obj = {"version": _STORE_VERSION,
                       "entries": dict(self._disk_entries)}
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(obj, f)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self._disk_mtime = os.stat(path).st_mtime_ns
        return path

    def load(self, path: str | None = None) -> int:
        """Merge entries from a JSON store; returns how many were loaded.

        The cache is an optimization, never a correctness dependency, so a
        corrupt / unreadable / unknown-version file degrades to a cold start
        (with a warning) instead of taking the job down; individually
        malformed entries are skipped the same way."""
        path = path or self.path
        if not path:
            raise ValueError("PlanCache.load: no path configured")
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            warnings.warn(f"PlanCache: ignoring unreadable store {path}: {e}")
            return 0
        if not isinstance(obj, dict) or obj.get("version") != _STORE_VERSION:
            return 0
        try:
            self._disk_mtime = os.stat(path).st_mtime_ns
        except OSError:
            self._disk_mtime = None
        self._disk_entries.update(obj.get("entries", {}))
        n = 0
        with self._lock:
            for k, pj in obj.get("entries", {}).items():
                try:
                    self._mem[k] = Plan.from_json(pj)
                except (KeyError, TypeError, ValueError) as e:
                    warnings.warn(f"PlanCache: skipping bad entry {k}: {e}")
                    continue
                self._mem.move_to_end(k)
                n += 1
            while len(self._mem) > self.capacity:
                self._mem.popitem(last=False)
        return n

    # -- §8.4 path-DP memo (in-memory only) ----------------------------------

    def path_memo_get(self, key):
        with self._lock:
            v = self._path_memo.get(key)
            if v is None:
                self.path_misses += 1
            else:
                self.path_hits += 1
            return v

    def path_memo_put(self, key, value) -> None:
        with self._lock:
            if len(self._path_memo) >= 4096:  # runaway-graph backstop
                self._path_memo.clear()
            self._path_memo[key] = value


# ---------------------------------------------------------------------------
# Path-memo keying + snapshot/apply (used by core/decomp.eindecomp)
# ---------------------------------------------------------------------------


def path_memo_key(
    g: EinGraph,
    path: list[int],
    labeled: set[int],
    plan: Plan,
    p: int,
    mesh_axes: dict[str, int] | None,
    cost_mode: str,
    offpath_repart: bool,
) -> tuple:
    """A hashable, label-name-free signature of one §8.4 path DP instance.

    Two path invocations share a key only when the DP over them is the same
    problem: identical node structures (canonical per-node form), identical
    relational wiring (producers encoded as path positions, free graph
    inputs, pinned off-path partitionings, or ignored off-path nodes), and
    identical pinned targets from already-labeled consumers (the EinDecomp+
    boundary term).  Everything cost-relevant is in the key, so a hit is
    exact, not approximate.
    """
    pos = {nid: j for j, nid in enumerate(path)}
    entries = []
    for nid in path:
        n = g.nodes[nid]
        rel = []
        for a in (n.inputs[i] for i in canon.operand_order(n)):
            na = g.nodes[a]
            if a in pos:
                rel.append(("path", pos[a]))
            elif na.kind == "input":
                rel.append(("input", tuple(na.shape), canon._dtype_str(na.dtype)))
            elif a in labeled:
                da = tuple(plan.d_by_node[a].get(l, 1) for l in na.labels)
                rel.append(("labeled", da, tuple(na.shape)))
            else:
                rel.append(("ignored",))
        pinned = []
        if offpath_repart:
            # same predicate the DP itself uses (decomp._optimize_path), so
            # key and cost inputs cannot drift apart
            for mn in _decomp._labeled_consumers(g, nid, labeled, pos, plan):
                dm = plan.d_by_node[mn]
                for ls_m in g.edge_labels(mn, nid):
                    pinned.append(tuple(dm.get(l, 1) for l in ls_m))
        entries.append((canon.node_struct(g, nid), tuple(rel),
                        tuple(sorted(pinned))))
    mesh_sig = (tuple(sorted(mesh_axes.items()))
                if mesh_axes is not None else None)
    return (tuple(entries), int(p), mesh_sig, cost_mode, bool(offpath_repart))


def snapshot_path(g: EinGraph, path: list[int], plan: Plan) -> list[tuple]:
    """Capture the plan entries ``_optimize_path`` just produced for the
    path nodes, in canonical labels (the memo value)."""
    out = []
    for nid in path:
        ren = canon.node_label_map(g, nid)
        d = {ren.get(l, l): v for l, v in plan.d_by_node[nid].items()}
        ax = {ren.get(l, l): tuple(a)
              for l, a in plan.axes_by_node.get(nid, {}).items()}
        out.append((d, ax))
    return out


def apply_path(g: EinGraph, path: list[int], value: list[tuple],
               plan: Plan) -> None:
    """Write a memoized path result into ``plan`` in ``g``'s own labels."""
    for nid, (d, ax) in zip(path, value):
        inv = {c: o for o, c in canon.node_label_map(g, nid).items()}
        plan.d_by_node[nid] = {inv.get(l, l): v for l, v in d.items()}
        if ax:
            plan.axes_by_node[nid] = {inv.get(l, l): tuple(a)
                                      for l, a in ax.items()}
