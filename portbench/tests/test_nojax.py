"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import core

PB = Path(__file__).resolve().parents[1]


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_and_costs_import_neither_package():
    """Also each constraint kind's and scene kind's file."""
    files = [f for sub in ("reference", "costs")
             for f in (PB / sub).rglob("*.py")]
    assert {"kinds", "scenes"} <= {f.parent.name for f in files}
    for f in files:
        tops = imported_tops(f)
        assert not tops & {"jax", "jaxlib", "flax", "animsnapbases_tpu",
                           "animsnapbases_tpu_torch"}, (f, tops)


def test_no_module_of_the_benchmark_imports_jax():
    for f in PB.rglob("*.py"):
        assert not imported_tops(f) & {"jax", "jaxlib", "flax",
                                       "animsnapbases_tpu"}, f


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "animsnapbases_tpu_torch_x", sys)
    assert "animsnapbases_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "animsnapbases_tpu.sim", sys)
    assert "animsnapbases_tpu" in core.forbidden_modules()


def test_a_run_loads_neither(tmp_path):
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from portbench import core\n"
        "from portbench.tests.tiny import tiny_root\n"
        "root = tiny_root(Path(sys.argv[2]))\n"
        "core.run(root, 'cloth120.serve', 3, 0.1, True, device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(core.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(PB.parent),
                          str(tmp_path / "root")], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = out.stdout.strip().splitlines()
    assert tops[-1] == "[]"
    assert "animsnapbases_tpu_torch" in tops[-2]
