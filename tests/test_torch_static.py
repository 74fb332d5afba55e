"""Static and process-level checks on the port: it imports nothing of JAX or
of the JAX package, imports without JAX, and its chip smoke test refuses to
run (non-zero, no result line) where there is no card or no package."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [(root, line) for root, line in imported_roots(path) if root in FORBIDDEN_ROOTS]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code: str, cwd=ROOT, env_extra=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_in_a_process_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None  # any import of jax now raises ImportError\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.bridge, repro_torch.configs, repro_torch.models\n"
        "import repro_torch.serving, repro_torch.kernels.ops, repro_torch.launch.serve\n"
        "import repro_torch.training, repro_torch.launch.train\n"
        "import repro_torch.core, repro_torch.core.h100_slice, repro_torch.core.arch_bridge\n"
        "from repro_torch.core import (cluster, controller, deployment, exact, ga, greedy,\n"
        "    lower_bound, mcts, mig, online_profiles, optimizer, profiles, rms, zoo)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS, 'a kernel was built at import'\n"
        "print('ok')\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, even on a machine with one
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    res = _smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("name,replaces", [
    ("decode_attention.cu", "src/repro/kernels/decode_attention.py"),
    ("flash_attention.cu", "src/repro/kernels/flash_attention.py"),
    ("paged_attention.cu", "src/repro/kernels/paged_attention.py"),
    ("ssm_scan.cu", "src/repro/kernels/ssm_scan.py"),
])
def test_each_cuda_source_opens_with_its_note(name, replaces):
    head = (PORT / "kernels" / "csrc" / name).read_text().split("#include")[0]
    assert f"Replaces: {replaces}" in head
    assert "What bounds it on the H100" in head
    assert "Design:" in head


def test_build_needs_nvcc_and_says_so(monkeypatch):
    from repro_torch.kernels import _build

    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
