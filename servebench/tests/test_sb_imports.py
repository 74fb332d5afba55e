"""Import isolation: nothing under servebench loads JAX or the JAX package
(``repro``, compared by whole top-level name: ``repro_torch`` is the
program), the yardstick (reference/, counts/, and the weights the reference
makes: weights.py, layouts/) loads nothing of the program,
and nothing reads chip_smoke or the JAX package's benchmarks."""

import ast
import subprocess
import sys

import pytest
from conftest import ROOT, SB

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module the file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


FILES = sorted(SB.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(SB)) for p in FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    names = imported(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert not names & {"chip_smoke", "benchmarks"}
    if path.parent.name != "tests":  # nor reads them as files
        assert "chip_smoke" not in path.read_text() and "benchmarks/" not in path.read_text()


YARDSTICK = (sorted((SB / "reference").rglob("*.py")) + sorted((SB / "counts").rglob("*.py"))
             + sorted((SB / "layouts").rglob("*.py")) + [SB / "weights.py"])


@pytest.mark.parametrize("path", YARDSTICK, ids=[str(p.relative_to(SB)) for p in YARDSTICK])
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


def test_whole_name_comparison():
    # the check compares top-level names whole: the program's name begins with the JAX package's
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.sim".split(".")[0] in FORBIDDEN


def test_a_run_holds_no_jax_module_after_serving(tiny_base):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from servebench import harness\n"
        "out = harness.run_cell('tiny.burst', 3, 0.5, False, device='cpu', bench=%r,"
        " base=Path(%r))\n"
        "print('FORBIDDEN', out['_forbidden'])\n"
    ) % (str(ROOT), str(ROOT / "src"), tiny_base[1], str(tiny_base[0]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "servebench/run.py", "--workload", "granite-20b.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout


def test_the_command_refuses_in_a_folder_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(SB, tmp_path / "servebench", ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "servebench/run.py", "--workload", "granite-20b.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
