"""The port's static verifier (``repro_torch.analysis``) against the
reference's.

The passes are backend-free Python over graphs, plans and schedules that
both packages build equally, so every comparison here is exact: the same
findings (codes, severities, messages) and the same memory numbers.  The
only text that differs is a node's source location, which names the
package that built it (``src/repro_torch/...`` for ``src/repro/...``, at
the same line); ``_norm`` maps one onto the other.

1. **The corpus.**  Each ``tests/analysis_corpus/`` fixture runs through
   the port: its source is read, ``repro.`` rewritten to ``repro_torch.``
   in its imports, and executed under the fixture's own file name (so the
   source locations are the reference run's).  It trips its ``EXPECT``
   code as an error, and its whole report equals the reference's.
2. **The zoo** (every family x prefill/decode/paged, reduced) analyzes
   clean at lookahead 0, 1 and 2 and under the pipeline pass, with
   reports equal to the reference's.
3. **The CLI** over the zoo, in a subprocess: exit 0, a clean report equal
   to the reference CLI's, and at its end neither ``jax`` nor ``repro`` in
   ``sys.modules`` and CUDA never initialized.  ``--list-codes`` prints
   the reference's table.
4. **Hooks and plumbing**: ``BucketRegistry.analyze()`` key by key,
   ``Finding``/``Report`` defaults and JSON, unknown codes, source
   locations reaching findings.
"""
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import analyze as ref_analyze  # noqa: E402
from repro.analysis.__main__ import main as ref_main  # noqa: E402
from repro.analysis.__main__ import _cell_program as ref_cell_program  # noqa: E402
from repro.analysis.runner import analyze_program as ref_analyze_program  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.pipeline import PipelineSpec as RefSpec  # noqa: E402
from repro.serving.buckets import BucketRegistry as RefBucketRegistry  # noqa: E402

from repro_torch import frontend as ein  # noqa: E402
from repro_torch.analysis import (CODES, ERROR, WARNING, Finding, Report,  # noqa: E402
                                  analyze)
from repro_torch.analysis.__main__ import FAMILIES, MODES, PAGED_FAMILIES  # noqa: E402
from repro_torch.analysis.__main__ import _cell_program, main  # noqa: E402
from repro_torch.analysis.runner import analyze_program  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.einsum import EinGraph  # noqa: E402
from repro_torch.pipeline import PipelineSpec  # noqa: E402
from repro_torch.serving.buckets import BucketRegistry  # noqa: E402

from tests.analysis_corpus import FIXTURES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "analysis_corpus"


def _norm(payload):
    """A report's JSON with the port's source paths written as the
    reference's."""
    text = json.dumps(payload, sort_keys=True)
    return json.loads(text.replace("src/repro_torch/", "src/repro/"))


# ---------------------------------------------------------------------------
# 1. the corpus
# ---------------------------------------------------------------------------


def _port_fixture(name: str) -> types.ModuleType:
    path = CORPUS / f"{name}.py"
    src = re.sub(r"\brepro\.", "repro_torch.", path.read_text())
    assert "from repro_torch." in src and not re.search(r"\brepro\.", src)
    mod = types.ModuleType(f"port_corpus_{name}")
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_corpus_fixture_trips_its_code_as_the_reference(name):
    mod = _port_fixture(name)
    report = mod.report()
    assert mod.EXPECT == FIXTURES[name].EXPECT
    assert any(f.code == mod.EXPECT and f.severity == ERROR
               for f in report.findings), report.format()
    assert report.has_errors
    for f in report.findings:
        assert f.code in CODES
    assert _norm(report.to_json()) == FIXTURES[name].report().to_json()
    assert report.format() == FIXTURES[name].report().format()


# ---------------------------------------------------------------------------
# 2. the zoo
# ---------------------------------------------------------------------------

ZOO_CELLS = [(f, m) for f in FAMILIES for m in MODES
             if m != "paged" or f in PAGED_FAMILIES]


@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("family,mode", ZOO_CELLS)
def test_zoo_clean_and_equal_to_reference(family, mode, lookahead):
    mesh = {"data": 2, "model": 4}
    rep = analyze_program(_cell_program(family, mode), mesh, lookahead=lookahead)
    want = ref_analyze_program(ref_cell_program(family, mode), mesh,
                               lookahead=lookahead)
    assert not rep.findings, rep.format()
    assert rep.memory["peak_bytes"] > 0
    n_pf = rep.memory["n_prefetches"]
    if lookahead == 0:
        assert n_pf == 0
    elif mode == "prefill":  # the schedules really hoist
        assert n_pf > 0
    assert _norm(rep.to_json()) == want.to_json()


@pytest.mark.parametrize("p,m", [(1, 1), (1, 4), (2, 1), (2, 4)])
@pytest.mark.parametrize("family,mode", [(f, m) for f in FAMILIES
                                         for m in ("prefill", "decode")])
def test_zoo_clean_under_pipeline_pass(family, mode, p, m):
    """Error-free with the RA4xx pass; the only tolerated finding is the
    reference's RA404 imbalance warning, and the report equals the
    reference's."""
    mesh = {"pp": p, "data": 1, "model": 2}
    rep = analyze_program(_cell_program(family, mode), mesh,
                          pipeline=PipelineSpec(stages=p, microbatches=m))
    want = ref_analyze_program(ref_cell_program(family, mode), mesh,
                               pipeline=RefSpec(stages=p, microbatches=m))
    assert not rep.errors, rep.format()
    assert all(f.code == "RA404" for f in rep.warnings), rep.format()
    if family == "mixtral-8x7b" and m > 1:
        assert rep.meta.get("microbatches_clamped") == 1
    assert _norm(rep.to_json()) == want.to_json()


# ---------------------------------------------------------------------------
# 3. the CLI
# ---------------------------------------------------------------------------


def test_cli_zoo_clean_backend_free_and_equal_to_reference(tmp_path):
    """``python -m repro_torch.analysis`` over every family and mode: exit
    0 with no finding, the reference CLI's report, and at its end no jax,
    no reference package and no CUDA initialized in the process."""
    port_json, ref_json = tmp_path / "port.json", tmp_path / "ref.json"
    snippet = (
        "import sys, torch\n"
        "from repro_torch.analysis.__main__ import main\n"
        f"rc = main(['--json', {str(port_json)!r}])\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'repro' not in sys.modules, 'the reference imported'\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialized'\n"
        "sys.exit(rc)\n")
    proc = subprocess.run(
        [sys.executable, "-c", snippet], capture_output=True, text=True,
        env={"PYTHONPATH": "src"}, timeout=300,
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(port_json.read_text())
    assert payload["n_errors"] == 0 and payload["n_warnings"] == 0
    assert len(payload["cells"]) == 11
    for cell in payload["cells"]:
        assert cell["findings"] == [] and cell["memory"]["peak_bytes"] > 0
    assert ref_main(["--json", str(ref_json)]) == 0
    assert _norm(payload) == json.loads(ref_json.read_text())


def test_cli_list_codes_equals_reference(capsys):
    assert main(["--list-codes"]) == 0
    ours = capsys.readouterr().out
    assert ref_main(["--list-codes"]) == 0
    assert ours == capsys.readouterr().out
    assert {c[:3] for c in CODES} == {"RA0", "RA1", "RA2", "RA3", "RA4"}
    for code, (sev, desc) in CODES.items():
        assert sev in (ERROR, WARNING) and desc


def test_cli_flags_equal_reference(tmp_path, capsys):
    """--mesh, --max-hbm (RA301 on every cell: exit 1), --pp and
    --microbatches, --no-fuse: the same report as the reference CLI's."""
    for flags in (["--families", "llama-7b", "--mesh", "data=4,model=2",
                   "--max-hbm", "200000"],
                  ["--modes", "prefill,decode", "--pp", "2",
                   "--microbatches", "4", "--mesh", "data=1,model=2"],
                  ["--families", "hymba-1.5b", "--no-fuse", "--lookahead", "0"]):
        ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
        rc = main(flags + ["--json", str(ours)])
        capsys.readouterr()
        assert rc == ref_main(flags + ["--json", str(theirs)])
        assert _norm(json.loads(ours.read_text())) == json.loads(theirs.read_text())
    assert rc == 0


# ---------------------------------------------------------------------------
# 4. hooks and plumbing
# ---------------------------------------------------------------------------


def test_bucket_registry_analyze_equals_reference():
    ref_reg = RefBucketRegistry(ref_reduced(ref_get_config("llama-7b")),
                                make_host_mesh())
    reg = BucketRegistry(reduced(get_config("llama-7b")), device="cpu")
    for r in (ref_reg, reg):
        r.prefill(16, batch=2)
        r.decode(16, 2, 8)
    reports, want = reg.analyze(), ref_reg.analyze()
    assert list(reports) == list(want) and len(reports) == 2
    for key, rep in reports.items():
        assert not rep.findings, f"{key}:\n{rep.format()}"
        assert rep.memory["peak_bytes"] > 0
        assert _norm(rep.to_json()) == want[key].to_json()
    tight, tight_want = reg.analyze(max_hbm=64), ref_reg.analyze(max_hbm=64)
    assert any(r.has_errors and "RA301" in r.codes() for r in tight.values())
    for key, rep in tight.items():
        assert _norm(rep.to_json()) == tight_want[key].to_json()


def test_expr_srcloc_survives_into_graph_nodes():
    x = ein.tensor("x", "b s", (2, 4))
    y = ein.einsum("b s -> b", x, combine="id", agg="sum")  # pinned line
    prog = ein.Program({"y": y})
    node = prog.graph.nodes[prog._out["y"]]
    assert node.srcloc.startswith(str(Path(__file__)))
    line = int(node.srcloc.rsplit(":", 1)[1])
    assert "pinned line" in Path(__file__).read_text().splitlines()[line - 1]


def test_srcloc_lands_in_findings():
    g = EinGraph("loc")
    x = g.input("x", "a", (8,))
    nid = g.opaque("totally_unknown_op", [x], "a", (8,),
                   in_labels=[("a",)], name="mystery")
    g.nodes[nid].srcloc = "model.py:42"
    bad = [f for f in analyze(g).findings if f.code == "RA005"]
    assert bad and "model.py:42" in bad[0].format()


def test_finding_defaults_and_report_json():
    f = Finding("RA001", "dead node")
    assert f.severity == WARNING
    r = Report()
    r.add(f)
    r.add(Finding("RA102", "bad parts", nid=3, node="mm"))
    assert r.has_errors and len(r.warnings) == 1
    payload = r.to_json()
    assert payload["n_errors"] == 1
    assert {d["code"] for d in payload["findings"]} == {"RA001", "RA102"}
    assert json.loads(r.dump_json()) == payload


def test_unknown_code_rejected():
    with pytest.raises(ValueError, match="RA999"):
        Finding("RA999", "no such pass")


def test_analyze_graph_only_smoke():
    from repro.core.einsum import EinGraph as RefGraph

    def two(G):
        g = G("two")
        a = g.input("alpha", "ij", (4, 8))
        b = g.input("beta", "jk", (8, 2))
        g.einsum("ij, jk -> ik", a, b)
        return g

    g, rg = two(EinGraph), two(RefGraph)
    assert not analyze(g).findings
    dead, rdead = g.input("unused", "q", (3,)), rg.input("unused", "q", (3,))
    report = analyze(g, out_ids=[o for o in g.outputs() if o != dead])
    assert "RA001" in report.codes() and not report.has_errors
    want = ref_analyze(rg, out_ids=[o for o in rg.outputs() if o != rdead])
    assert _norm(report.to_json()) == want.to_json()


ITEMSIZE_DTYPES = ["float16", "bfloat16", "float32", "float64", "int8", "int32",
                   "int64", "bool"]


@pytest.mark.parametrize("name", ITEMSIZE_DTYPES)
def test_memory_pass_sizes_torch_dtypes_as_the_reference(name):
    """A graph typed by a torch dtype is priced, by the memory pass and the
    collectives alike, as the reference prices the same graph typed by
    numpy's (ml_dtypes') dtype of that name."""
    from repro.core.einsum import EinGraph as RefGraph
    from repro.frontend import Program as RefProgram

    def chain(G, dtype):
        g = G("typed")
        x = g.input("x", "b i", (16, 32), dtype=dtype)
        w = g.input("w", "i j", (32, 8), dtype=dtype)
        y = g.einsum("b i, i j -> b j", x, w)
        return g, y

    g, y = chain(EinGraph, getattr(torch, name))
    rg, ry = chain(RefGraph, name)
    mesh = {"data": 2, "model": 2}
    rep = analyze_program(ein.Program.from_graph(g, {"y": y}), mesh)
    want = ref_analyze_program(RefProgram.from_graph(rg, {"y": ry}), mesh)
    assert rep.memory["args_bytes"] > 0
    assert _norm(rep.to_json()) == want.to_json()


def test_itemsize_raises_on_a_dtype_it_cannot_size():
    from repro_torch.core.spmd import _itemsize

    assert _itemsize("bfloat16") == _itemsize(torch.bfloat16) == 2
    for bad in ("no_such_dtype", object()):
        with pytest.raises(TypeError, match="cannot size"):
            _itemsize(bad)
