"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports jax or the JAX package, and entry points never
drop to the CPU unless asked to."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES[:-1]}
    for want in ("repro_torch/core/decomp.py", "repro_torch/kernels/ops.py",
                 "repro_torch/models/transformer.py", "repro_torch/launch/serve.py",
                 "repro_torch/core/engine.py", "repro_torch/core/spmd.py",
                 "repro_torch/launch/mesh.py", "repro_torch/kernels/matmul.py",
                 "repro_torch/serving/__init__.py", "repro_torch/serving/paged_kv.py",
                 "repro_torch/serving/buckets.py", "repro_torch/serving/engine.py"):
        assert want in names
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scan_catches_a_banned_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from repro.core import canon\n    import jax.numpy\n")
    assert {"repro", "jax"} <= _imported_roots(f)


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve as port_serve
    from repro_torch.models import transformer as tf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("llama-7b"))
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.serve(cfg, prompts, max_new=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.serve(cfg, prompts, max_new=2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_caches(cfg, 1, 8)
    assert tf.init_caches(cfg, 1, 8, device="cpu")[0].k.device.type == "cpu"


def test_compiled_program_without_device_raises_when_cuda_is_absent(monkeypatch):
    """A compiled program runs on the card unless asked otherwise; the
    same program with device="cpu" runs."""
    from repro_torch import frontend as ein
    from repro_torch.core import engine
    from repro_torch.launch.mesh import Mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = ein.tensor("x", "b a", (4, 8))
    prog = ein.Program({"y": x.map("relu")})
    feeds = {"x": np.ones((4, 8), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prog.compile(p=1)(feeds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh({"data": 1, "model": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_runner(prog.graph)
    assert prog.compile(p=1, device="cpu")(feeds)["y"].device.type == "cpu"
    y = engine.make_runner(prog.graph, device="cpu")(feeds["x"])
    assert y.device.type == "cpu"
