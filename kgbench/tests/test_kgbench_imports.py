"""What the benchmark imports: nothing of JAX or of the JAX package
(top-level names compared whole, so ``openkeonspark_tpu_torch`` stays
importable), and its reference nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from kgbench_tiny import ROOT

REFUSE = (
    "import sys\n"
    "BLOCKED = {blocked!r}\n"
    "class Refuse:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in BLOCKED:\n"
    "            raise ImportError('blocked import of ' + name)\n"
    "sys.meta_path.insert(0, Refuse())\n"
    f"sys.path.insert(0, {str(ROOT)!r})\n")


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_imports_and_parses_without_jax():
    """Every module of the benchmark loads, every metric reader too, and
    ``main`` parses a cell's arguments and stops at the missing card (exit
    2, no result), with jax, jaxlib, flax and the JAX package refused."""
    code = REFUSE.format(blocked=("jax", "jaxlib", "flax",
                                  "openkeonspark_tpu")) + (
        "import importlib, pkgutil, kgbench, torch\n"
        "for m in pkgutil.walk_packages(kgbench.__path__, 'kgbench.'):\n"
        "    if '.tests' not in m.name and m.name != 'kgbench.calibrate':\n"
        "        importlib.import_module(m.name)\n"
        "from kgbench import harness\n"
        "b = harness.benchmark()\n"
        "for m in b['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "for w in b['workloads']:\n"
        "    harness.traffic_module(harness.load_cell(w['name'])['mix']['kind'])\n"
        "import openkeonspark_tpu_torch.train.step, "
        "openkeonspark_tpu_torch.eval.link_prediction\n"
        "if not torch.cuda.is_available():\n"
        "    rc = harness.main(['--workload', 'transe_d200_fb15k237.train',\n"
        "                       '--seed', '4294967296', '--seconds', '10',\n"
        "                       '--trace', '0'])\n"
        "    assert rc == 2, rc\n"
        "assert not harness.banned_modules(), harness.banned_modules()\n"
        "print('ok')\n")
    assert _run(code).strip().endswith("ok")


def test_reference_imports_nothing_of_the_port():
    code = REFUSE.format(blocked=("jax", "jaxlib", "flax",
                                  "openkeonspark_tpu",
                                  "openkeonspark_tpu_torch")) + (
        "import importlib, pkgutil, kgbench.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'kgbench.reference.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    assert _run(code).strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    (ROOT / "kgbench/reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_name_no_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for n in names:
            assert n.split(".")[0] in ("kgbench", "numpy", "torch",
                                       "__future__", "contextlib", "typing",
                                       "dataclasses"), (path.name, n)
