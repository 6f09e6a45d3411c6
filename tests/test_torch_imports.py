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
                 "repro_torch/models/transformer.py", "repro_torch/launch/serve.py"):
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
