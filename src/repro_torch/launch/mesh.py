"""Meshes of ``torch.distributed`` ranks, and a helper that spawns them.

A ``Mesh`` names the axes of a grid of ranks, one process per rank (one
card per rank on GPUs): ``Mesh({"data": 2, "model": 4})`` in each of 8
processes of an initialised process group.  Ranks are laid out row-major
over the axes (major→minor), as JAX linearises an axes tuple, so a rank's
coordinate, the peer of a point-to-point exchange and the slot of a
grouped reduce-scatter agree with the reference's ``shard_map``.

``torch.distributed.new_group`` is collective — every rank must call it,
in the same order — so the mesh builds all its process groups once, at
construction: one for every subset of its axes larger than one rank, in a
fixed order, and then the ``DeviceMesh`` of the same axes, sizes and
row-major rank layout (``dmesh``) that DTensor places tensors on (the
``gspmd`` executor and the model stack under a mesh, ``core/gspmd.py``).
A mesh whose axes all have size 1 needs no process group, no DeviceMesh
and no initialised ``torch.distributed``: that is the one-card case.

gloo ranks that hold CUDA tensors (several ranks sharing one card) have
DTensor's all-gathers staged through the host (``stage_all_gather``): on
torch 2.11 a functional all-gather of CUDA tensors over gloo never
returns, while gloo's all-reduce, reduce-scatter and all-to-all of CUDA
tensors complete.

``make_mesh``, ``make_host_mesh`` and ``make_production_mesh`` are the
reference's constructors over an initialised process group.

An abstract mesh (``Mesh(..., abstract=True)``) is the production mesh in
one process, for the dry run (``launch/dryrun.py``): this process is rank
0 of a process group on torch's ``"fake"`` backend
(``init_fake_process_group``, the counterpart of the reference's
``launch/hostdev.py``), whose collectives move nothing.  Its blocks are
abstract: ``"meta"`` tensors by default, which stand for blocks on the
ranks' cards (the ``DeviceMesh`` is of type ``"cuda"``), or fake tensors
(``FakeTensorMode``) of the device it is given.  It touches no card: no
``torch.cuda.set_device``, no CUDA initialisation.

``spawn`` starts N ranks as processes with a ``file://`` rendezvous in a
directory of the caller's (a per-test tmp path), runs a function in each
and returns what each returned.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.models.common import resolve_device


class Mesh:
    """Named axes over this process's rank.

    ``axes`` is ``{name: size}`` (major→minor).  ``device`` is where this
    rank's blocks live: the card of this rank by default (``cuda:<local
    rank>``), raising where there is none, or whatever is passed
    (``"cpu"`` for gloo ranks on the CPU).  ``abstract=True`` builds the
    mesh for abstract blocks (the module docstring): ``device`` (default
    ``"meta"``) is never resolved against a card."""

    def __init__(self, axes: dict[str, int], *, device=None,
                 abstract: bool = False):
        import torch.distributed as dist

        self.sizes = {str(a): int(s) for a, s in axes.items()}
        self.axis_names = tuple(self.sizes)
        self.world_size = math.prod(self.sizes.values())
        if self.world_size > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"Mesh {self.sizes}: {self.world_size} ranks need an "
                    "initialised torch.distributed process group "
                    "(init_process_group, or launch.mesh.spawn)")
            if dist.get_world_size() != self.world_size:
                raise ValueError(
                    f"Mesh {self.sizes} has {self.world_size} ranks, the "
                    f"process group {dist.get_world_size()}")
            self.rank = dist.get_rank()
        else:
            self.rank = 0
        self.coord = self.coord_of(self.rank)
        self.abstract = abstract
        if abstract:
            self.device = torch.device(device or "meta")
        else:
            if device is None and torch.cuda.is_available():
                device = f"cuda:{self.rank % torch.cuda.device_count()}"
            self.device = resolve_device(device)
            if self.device.type == "cuda":
                if self.device.index is None:
                    self.device = torch.device("cuda", torch.cuda.current_device())
                torch.cuda.set_device(self.device)  # NCCL works on the current card
        self._groups: dict[frozenset, Any] = {}
        self.dmesh = None
        if self.world_size > 1:
            self._build_groups()
            self._build_device_mesh()

    # -- coordinates --------------------------------------------------------------

    def coord_of(self, rank: int) -> dict[str, int]:
        """Row-major coordinate of ``rank`` over the mesh axes."""
        coord = {}
        for a in reversed(self.axis_names):
            rank, coord[a] = divmod(rank, self.sizes[a])
        return {a: coord[a] for a in self.axis_names}

    def rank_at(self, coord: dict[str, int]) -> int:
        rank = 0
        for a in self.axis_names:
            rank = rank * self.sizes[a] + coord[a]
        return rank

    def linear_index(self, axes, coord: dict[str, int] | None = None) -> int:
        """Row-major index of ``coord`` (default: this rank's) along
        ``axes`` in the order given."""
        coord = self.coord if coord is None else coord
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + coord[a]
        return idx

    def rank_at_linear(self, axes, idx: int) -> int:
        """The rank that agrees with this one off ``axes`` and sits at
        row-major index ``idx`` along them."""
        coord = dict(self.coord)
        for a in reversed(tuple(axes)):
            idx, coord[a] = divmod(idx, self.sizes[a])
        return self.rank_at(coord)

    def members(self, axes) -> list[int]:
        """Global ranks of this rank's group over ``axes``, ascending (a
        process group's own member order)."""
        axes = set(axes)
        free = [a for a in self.axis_names if a in axes]
        out = []
        for vals in itertools.product(*(range(self.sizes[a]) for a in free)):
            coord = dict(self.coord)
            coord.update(zip(free, vals))
            out.append(self.rank_at(coord))
        return sorted(out)

    def member_indices(self, axes) -> list[int]:
        """For each member of the group over ``axes`` (in group order), its
        row-major index along ``axes`` in the order given."""
        return [self.linear_index(axes, self.coord_of(r))
                for r in self.members(axes)]

    # -- process groups --------------------------------------------------------------

    def _build_groups(self) -> None:
        import torch.distributed as dist

        big = [a for a in self.axis_names if self.sizes[a] > 1]
        for n in range(1, len(big) + 1):
            for subset in itertools.combinations(big, n):
                fixed = [a for a in self.axis_names if a not in subset]
                # every group of this subset, in the same order on every rank
                for vals in itertools.product(*(range(self.sizes[a])
                                                for a in fixed)):
                    base = dict(zip(fixed, vals))
                    ranks = sorted(
                        self.rank_at({**base, **dict(zip(subset, sv))})
                        for sv in itertools.product(
                            *(range(self.sizes[a]) for a in subset)))
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[frozenset(subset)] = pg

    def _build_device_mesh(self) -> None:
        """The DTensor ``DeviceMesh`` over the same ranks (collective: it
        builds one process group per axis, after ``_build_groups`` on every
        rank)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        ranks = torch.arange(self.world_size).reshape(
            tuple(self.sizes.values()))
        # meta blocks stand for blocks on the ranks' cards
        kind = "cuda" if self.device.type == "meta" else self.device.type
        self.dmesh = DeviceMesh(kind, ranks, mesh_dim_names=self.axis_names)
        if self.device.type == "cuda" and dist.get_backend() == "gloo":
            stage_all_gather("CUDA")

    def group(self, axes):
        """This rank's process group over ``axes`` (any order)."""
        key = frozenset(a for a in axes if self.sizes[a] > 1)
        if key not in self._groups:
            raise KeyError(f"mesh {self.sizes}: no process group over "
                           f"{sorted(axes)} (size-1 axes carry no "
                           "collectives)")
        return self._groups[key]

    def __repr__(self):
        return (f"Mesh({self.sizes}, rank={self.rank}, coord={self.coord}, "
                f"device={self.device})")


from repro_torch.core.engine import mesh_axes_dict  # noqa: E402,F401  (re-export)


# ---------------------------------------------------------------------------
# Host-staged all-gathers for gloo ranks on a card
# ---------------------------------------------------------------------------

_STAGED: dict[str, Any] = {}


def _staged_all_gather(inp, group_size: int, group_name: str):
    """``_c10d_functional.all_gather_into_tensor`` with its buffers on the
    host: the input block is copied to the host, gathered there by gloo,
    and the result copied back to the input's device."""
    import warnings

    import torch.distributed as dist
    from torch._C._distributed_c10d import _resolve_process_group

    host = inp.detach().to("cpu").contiguous()
    out = torch.empty((group_size * host.shape[0],) + tuple(host.shape[1:]),
                      dtype=host.dtype)
    with warnings.catch_warnings():  # renamed all_gather_single in 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, host,
                                    group=_resolve_process_group(group_name))
    return out.to(inp.device)


def stage_all_gather(dispatch_key: str) -> None:
    """Route DTensor's all-gathers of tensors with ``dispatch_key``
    (``"CUDA"``) through the host, once per process: the functional
    all-gather op gets a kernel for that key (``torch.library``) that
    stages its buffers.  Every other collective keeps its own kernel, and
    the op itself — what ``CommDebugMode`` counts — is unchanged.  A mesh
    of gloo ranks on a card calls this at construction; tests call it with
    ``"CPU"`` to run the staged path on CPU ranks."""
    import warnings

    if dispatch_key in _STAGED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():  # replacing the registered kernel
        warnings.simplefilter("ignore")
        lib.impl("all_gather_into_tensor", _staged_all_gather, dispatch_key)
    _STAGED[dispatch_key] = lib


# ---------------------------------------------------------------------------
# The reference's mesh constructors
# ---------------------------------------------------------------------------


def make_mesh(shape, axes, *, device=None, abstract: bool = False) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``axes`` (major→minor)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ "
                         "in length")
    return Mesh(dict(zip(axes, shape)), device=device, abstract=abstract)


def world_size() -> int:
    """Ranks in the initialised process group, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_host_mesh(shape=(2, 4), axes=("data", "model"), *,
                   device=None) -> Mesh:
    """A small mesh over whatever ranks exist (tests, host benchmarks):
    ``shape`` where the process group has that many ranks, else ``(1, n)``
    with ``n`` its world size (1 without one) — the reference's rule."""
    n = world_size()
    if math.prod(shape) > n:
        shape = (1, n)
    return make_mesh(shape, axes, device=device)


PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh: (16, 16) over ``("data", "model")``, or
    (2, 16, 16) over ``("pod", "data", "model")``, over an initialised
    process group of exactly that many ranks (the dry run builds it on a
    fake one: ``launch.dryrun.production_mesh``)."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    if world_size() != math.prod(shape):
        raise RuntimeError(
            f"make_production_mesh: {dict(zip(axes, shape))} needs an "
            f"initialised process group of {math.prod(shape)} ranks; this "
            f"process has {world_size()}")
    return make_mesh(shape, axes, device=device)


def init_fake_process_group(world: int) -> None:
    """Make this process rank 0 of a process group of ``world`` ranks on
    torch's ``"fake"`` backend (``FakeStore``: no rendezvous, and
    collectives that return at once and move nothing) — what an abstract
    mesh runs over.  A fake group of another size is destroyed first; a
    real one raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("init_fake_process_group: a real process group "
                               f"({dist.get_backend()}) is initialised")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, rdzv: str, backend: str,
               out_dir: str, args: tuple) -> None:
    import torch.distributed as dist

    out = Path(out_dir) / f"rank{rank}.pkl"
    try:
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=rdzv, rank=rank,
                                world_size=world)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    out.write_bytes(pickle.dumps(result))


def spawn(world: int, fn: Callable, *args, tmpdir, backend: str = "gloo",
          timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one process group (``file://`` rendezvous under ``tmpdir``); returns
    the list of their return values, by rank.  ``fn`` and ``args`` must
    pickle (``fn`` a module-level function).  Raises with the failing
    rank's traceback if any rank fails, or if the ranks outlive
    ``timeout`` seconds (they are then killed)."""
    tmp = Path(tmpdir)
    tmp.mkdir(parents=True, exist_ok=True)
    rdzv = tmp / "rendezvous"
    if rdzv.exists():
        rdzv.unlink()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, f"file://{rdzv}", backend,
                               str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    if alive:
        raise TimeoutError(f"spawn: {len(alive)} of {world} ranks still ran "
                           f"after {timeout} s and were killed")
    results = []
    for r, p in enumerate(procs):
        path = tmp / f"rank{r}.pkl"
        if not path.exists():
            raise RuntimeError(f"spawn: rank {r} exited with code "
                               f"{p.exitcode} and reported nothing")
        status, value = pickle.loads(path.read_bytes())
        os.unlink(path)
        if status != "ok":
            raise RuntimeError(f"spawn: rank {r} failed:\n{value}")
        results.append(value)
    return results
