"""Build the CUDA kernels at first use and load them with ctypes.

Every ``*.cu`` file under ``kaito_tpu_torch/csrc/`` compiles with
``nvcc`` into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  All sources compile at
once, one ``nvcc`` process each.  Libraries land in
``build/kernels/<key>/`` at the checkout root, where ``<key>`` is a
hash of the sources under ``csrc/`` and of nothing else, so an edited
kernel never loads a stale library.

Bindings: pointers and the stream pass as ``ctypes.c_void_p``; the
stream is ``torch.cuda.current_stream().cuda_stream``.  Each C entry
point returns ``cudaGetLastError()`` after its launch and
:func:`check` raises when that is not 0.  :func:`launch` makes the
tensors' device current around the call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    pass


def source_key() -> str:
    """Hash of every file under csrc/ (names and bytes)."""
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return path


def build_dir() -> Path:
    return BUILD_ROOT / source_key()


def build_all(ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every csrc/*.cu that has no library yet, all in parallel.

    Returns each newly built source's compiler output (``-Xptxas -v``
    adds registers, shared memory and spills per kernel).  Raises
    :class:`KernelBuildError` when any compile fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [src for src in sorted(CSRC.glob("*.cu"))
            if not (out_dir / f"lib{src.stem}.so").exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        # atomic publish: a concurrent build never loads a partial file
        os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(stem: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<stem>.cu``."""
    build_all()
    return ctypes.CDLL(str(build_dir() / f"lib{stem}.so"))


def bind(stem: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(load_library(stem), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(device: torch.device, fn: ctypes._CFuncPtr, *args) -> int:
    """Call the kernel entry ``fn`` with ``device`` as the current CUDA
    device: a ctypes launch goes to the current device, and the shards of
    a tensor-parallel engine live on several."""
    with torch.cuda.device(device):
        return fn(*args)


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
