"""``Program.compile(donate=)`` on the CPU: the port frees a donated feed's
storage after its last reader, where the reference's jit donates the
buffer to XLA.

* ``donate_argnums`` equals the reference's (also
  ``tests/test_torch_planner.py``).
* A donated call's outputs are bit for bit an undonated call's, through
  the dense runner, the ``shard_map`` runner on a one-rank mesh, and the
  ``gspmd`` and ``shard_map`` runners on two gloo ranks.
* Every donated feed raises on any later use (``DonatedTensor``); feeds
  not donated, numpy feeds, a donated feed that is also an output and two
  donated feeds sharing one storage are left as they were (the static
  verifier's RA202 cases), and so is a donated view of a tensor not fed,
  with its base.
* The memory pass's per-device peak with the donation set equals the
  reference's, and is no higher than the undonated peak (below it on one
  rank).  (The allocator's peak of
  a donated call against it: ``tests/test_torch_kernels_gpu.py`` and
  chip_smoke phase 34(b), on the card.)
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import analyze_compiled as ref_analyze  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.models.eingraphs import program_for as ref_program_for  # noqa: E402

from repro_torch import frontend as ein  # noqa: E402
from repro_torch.analysis import analyze_compiled  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.engine import DonatedTensor  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models.eingraphs import program_for  # noqa: E402

SHAPE = ("s", "prefill", 16, 2)


def _prog():
    return program_for(reduced(get_config("llama-7b")), ShapeConfig(*SHAPE))


def _feeds(prog, seed=0) -> dict:
    """Seeded torch feeds of ``prog``'s inputs (each its own storage)."""
    rng = np.random.default_rng(seed)
    vocab = reduced(get_config("llama-7b")).vocab
    return {n.name: torch.from_numpy(
                rng.integers(0, vocab, size=n.shape).astype(np.int32)
                if "int" in str(n.dtype)
                else (rng.normal(size=n.shape) * 0.1).astype(np.float32)).clone()
            for n in prog.graph.nodes if n.kind == "input"}


def _copy(feeds):
    return {k: v.clone() for k, v in feeds.items()}


def _compile(prog, executor, donate):
    if executor == "dense":
        return prog.compile(p=1, device="cpu", donate=donate)
    return prog.compile(mesh=Mesh({"data": 1, "model": 1}, device="cpu"),
                        executor="shard_map", donate=donate)


def _raises(t) -> bool:
    try:
        t + 1
    except RuntimeError as e:
        return "donated" in str(e)
    return False


@pytest.mark.parametrize("executor", ["dense", "shard_map"])
def test_donated_call_equals_undonated_and_frees_its_feeds(executor):
    prog = _prog()
    feeds = _feeds(prog)
    want = _compile(prog, executor, False)(_copy(feeds))
    donated = _copy(feeds)
    got = _compile(prog, executor, True)(donated)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(type(t) is DonatedTensor and _raises(t) for t in donated.values())
    with torch._C.DisableTorchFunctionSubclass():  # look past the raise: freed
        assert all(t.untyped_storage().nbytes() == 0 for t in donated.values())
    # a name list: only those, and the rest left as they were
    names = sorted(feeds)[:3]
    part = _copy(feeds)
    got = _compile(prog, executor, names)(part)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for name, t in part.items():
        if name in names:
            assert type(t) is DonatedTensor, name
        else:
            assert type(t) is torch.Tensor and torch.equal(t, feeds[name]), name
    # numpy feeds are copied in, never freed
    arrays = {k: v.numpy().copy() for k, v in feeds.items()}
    got = _compile(prog, executor, True)(arrays)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, a in arrays.items():
        np.testing.assert_array_equal(a, feeds[k].numpy())


def _echo_program():
    """``y = sum_s x * w`` beside ``x`` itself as an output."""
    x = ein.tensor("x", "b s", (2, 4))
    w = ein.tensor("w", "s", (4,))
    y = ein.einsum("b s, s -> b", x, w)
    return ein.Program({"y": y, "x_out": x})


@pytest.mark.parametrize("executor", ["dense", "shard_map"])
def test_output_and_aliased_donations_are_not_freed(executor):
    """RA202's cases: a donated feed that is also an output stays whole,
    and so do two donated feeds sharing one storage; the other donated
    feed of the call is freed."""
    prog = _echo_program()
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    w = torch.ones(4)
    out = _compile(prog, executor, True)({"x": x, "w": w})
    assert type(x) is torch.Tensor and torch.equal(out["x_out"], x)
    assert type(w) is DonatedTensor
    torch.testing.assert_close(out["y"], torch.tensor([6.0, 22.0]))
    both = torch.ones(2, 4)
    out = _compile(prog, executor, True)({"x": both, "w": both[0]})
    assert type(both) is torch.Tensor and torch.equal(both, torch.ones(2, 4))
    torch.testing.assert_close(out["y"], torch.tensor([4.0, 4.0]))


@pytest.mark.parametrize("executor", ["dense", "shard_map"])
@pytest.mark.parametrize("piece", ["first_row", "last_row", "split"])
def test_donated_view_leaves_its_base_whole(executor, piece):
    """A donated feed that is a view of a tensor not fed (a row, one piece
    of ``split``) does not own its storage: freeing it would take the
    base's memory, which was not donated.  Both stay plain tensors with
    their values; the other donated feed is freed."""
    x = ein.tensor("x", "b s", (2, 4))
    prog = ein.Program({"y": ein.einsum("b s, s -> b", x, ein.tensor("w", "s", (4,)))})
    big = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    w = {"first_row": lambda: big[0], "last_row": lambda: big[2],
         "split": lambda: torch.split(big.reshape(-1), 4)[1]}[piece]()
    want_w = w.clone()
    x = torch.ones(2, 4)
    out = _compile(prog, executor, True)({"x": x, "w": w})
    torch.testing.assert_close(out["y"], torch.full((2,), float(want_w.sum())))
    assert type(x) is DonatedTensor
    assert type(big) is torch.Tensor and type(w) is torch.Tensor
    assert torch.equal(big, torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert torch.equal(w, want_w)


def _two_ranks(rank, world, executor):
    """A donated and an undonated call on two gloo ranks: both outputs, and
    whether every donated feed raises afterwards."""
    prog = _prog()
    feeds = _feeds(prog)
    mesh = Mesh({"data": 2}, device="cpu")
    want = prog.compile(mesh=mesh, executor=executor)(_copy(feeds))
    donated = _copy(feeds)
    got = prog.compile(mesh=mesh, executor=executor, donate=True)(donated)
    return ({k: v.numpy() for k, v in want.items()}, {k: v.numpy() for k, v in got.items()},
            all(type(t) is DonatedTensor and _raises(t) for t in donated.values()))


@pytest.mark.parametrize("executor", ["gspmd", "shard_map"])
def test_donation_on_two_ranks(executor, tmp_path):
    for rank, (want, got, freed) in enumerate(spawn(2, _two_ranks, executor, tmpdir=tmp_path,
                                                    timeout=300)):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {rank} {k}")
        assert freed, rank


def _norm(payload):
    text = json.dumps(payload, sort_keys=True)
    return json.loads(text.replace("src/repro_torch/", "src/repro/"))


@pytest.mark.parametrize("axes", [{"data": 1}, {"data": 2, "model": 2}], ids=["1", "2x2"])
def test_memory_pass_prices_the_donation_as_the_reference(axes):
    prog = _prog()
    ref_prog = ref_program_for(ref_reduced(ref_get_config("llama-7b")), RefShape(*SHAPE))
    names = sorted(n.name for n in prog.graph.nodes if n.kind == "input")
    peaks = {}
    for donate in (False, True, names[:4]):
        run = prog.compile(mesh_axes=axes, donate=donate, device="cpu")
        ref_run = ref_prog.compile(mesh_axes=axes, donate=donate)
        got = analyze_compiled(run, mesh_axes=axes)
        want = ref_analyze(ref_run, mesh_axes=axes)
        assert _norm(got.to_json()) == want.to_json(), donate
        peaks[str(donate)] = got.memory["peak_bytes"]
    # on (2, 2) the peak sits where every input still has a reader to come
    assert peaks["True"] <= peaks["False"], peaks
    if axes == {"data": 1}:
        assert peaks["True"] < peaks["False"], peaks
