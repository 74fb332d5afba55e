"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/repro_torch/<hash>/`` at
the root of the checkout, keyed by a hash of every source under ``csrc/``
and the flags, so an edited kernel is rebuilt and an unchanged one is not.
Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.

    from repro_torch.kernels import _build
    _build.build_all()          # compile every kernel, one nvcc each, in parallel
    lib = _build.load("paged_attention")
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("decode_attention", "flash_attention", "paged_attention", "ssm_scan",
           "flash_attention_bwd", "ssm_scan_bwd", "norm_rope")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--ptxas-options=-v",
]

# torch dtype -> the dtype code the C interface takes (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built; returns
    the job for :func:`_finish`, or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with open(out.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}):\n{build_log(name)}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file


def build_all(names=KERNELS) -> None:
    """Compile every named kernel, all nvcc processes started together."""
    jobs = [(n, _start(n)) for n in names]
    for n, job in jobs:
        _finish(n, job)


def sass(name: str) -> str:
    """The built library's machine code (``cuobjdump -sass``), from the
    cuobjdump beside nvcc."""
    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    out = subprocess.run([str(tool), "-sass", str(_lib_path(name))], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {name}: {out.stderr.strip()}")
    return out.stdout


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (register, shared-memory and spill counts)."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name))
            _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
        return _LIBS[name]


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    if name == "decode_attention":
        fn = lib.repro_decode_attention
        fn.argtypes = [p] * 8 + [i] * 8 + [i64] * 6 + [f, p]
    elif name == "flash_attention":
        fn = lib.repro_flash_attention
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, f, i, p, p]
    elif name == "flash_attention_bwd":
        fn = lib.repro_flash_attention_bwd
        fn.argtypes = [p] * 10 + [i] * 6 + [p, f, i, p]
    elif name == "paged_attention":
        fn = lib.repro_paged_decode_attention
        fn.argtypes = [p] * 9 + [i] * 9 + [i64, i64, f, p]
    elif name == "ssm_scan":
        fn = lib.repro_ssm_scan
        fn.argtypes = [p] * 10 + [i] * 7 + [p, i64, p]
    elif name == "ssm_scan_bwd":
        fn = lib.repro_ssm_scan_bwd
        fn.argtypes = [p] * 18 + [i] * 6 + [p, i64, p]
    elif name == "norm_rope":
        lib.repro_rmsnorm.argtypes = [p] * 5 + [i, i64, i, i64, i64, f, p]
        lib.repro_rmsnorm.restype = ctypes.c_int
        fn = lib.repro_rope
        fn.argtypes = [p, p, p] + [i] * 6 + [p, f, p]
    else:
        raise ValueError(f"unknown kernel {name!r}")
    fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def rows_aligned(t: torch.Tensor, nbytes: int) -> bool:
    """True if every last-axis row of ``t`` starts on an ``nbytes`` boundary."""
    size = t.element_size()
    return t.data_ptr() % nbytes == 0 and all(
        (t.stride(d) * size) % nbytes == 0 for d in range(t.dim() - 1)
    )


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy of it in fresh storage where one of its
    last-axis rows does not start on a 16-byte boundary."""
    return t if rows_aligned(t, 16) else t.clone(memory_format=torch.contiguous_format)


def strides_arg(tensors: List[torch.Tensor], dims) -> ctypes.Array:
    """An int64 array of the given stride dims of each tensor, in order."""
    vals = [t.stride(d) for t in tensors for d in dims]
    return (ctypes.c_int64 * len(vals))(*vals)
