"""What the harness loads: no module of JAX or of the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``), nothing read from ``benchmarks/``, and plain references that
import nothing of the program."""
import ast
import json
import subprocess
import sys
import types

import pytest

from bench import harness

BENCH = harness.HERE
RUN_FILES = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def imported(path) -> set:
    """Top-level names of every module ``path`` imports (absolute
    imports; relative ones stay inside ``bench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in RUN_FILES:
        assert not imported(path) & set(harness.FOREIGN), path
        assert "benchmarks/" not in path.read_text(), path


def test_the_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "math", "numpy", "torch"}, \
            path
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]; "
            "import bench.reference.gcn, bench.reference.lm; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'repro_torch'))")
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(harness.ROOT),
                                           src=str(harness.ROOT / "src"))],
        capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_foreign_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert "repro_torch_like" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.fake",
                        types.ModuleType("repro.fake"))
    assert "repro.fake" in harness.foreign_modules()


def test_a_whole_run_loads_no_foreign_module():
    """A CPU run of every cell at a tiny size, in a fresh process, then
    the run's own check of ``sys.modules``."""
    code = f"""
import sys, time, json
sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / 'src')!r}]
from bench import generate, harness
t = time.perf_counter()
gcn = dict(generate.load("configs", "gcn-ogbn-arxiv"), n_nodes=300,
           in_dim=8, hidden_dim=16, out_dim=4)
lm = dict(generate.load("configs", "stablelm-1.6b-sparse-band"), n_layers=1,
          d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64)
stream = dict(generate.load("traffic", "stream.4x2048"), seq_len=32)
for w in harness.manifest()["workloads"]:
    cfg = gcn if w["config"] == "gcn-ogbn-arxiv" else lm
    tr = stream if w["config"] != "gcn-ogbn-arxiv" else None
    r = harness.run(w["name"], 1, 0.2, False, device="cpu", t_start=t,
                    config=cfg, traffic=tr, log=lambda s: None)
    assert r["correct"], r
print(json.dumps(harness.foreign_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "gcn-arxiv.train.band", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        cwd=str(harness.ROOT))
    assert proc.returncode == 2 and proc.stdout == ""
