"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` — one process
per source, all started together — and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``.  Headers
(``csrc/*.cuh``) are included by the sources that use them.  No
PyTorch headers are involved, so a build takes seconds.

The build runs at first use, from the package's sources only, into
``build/arroyo_tpu_torch/`` at the repository root; the library's name
carries a hash of the sources and flags, so an edited source can never
load a stale binary.  A missing ``nvcc`` or a failed build raises — there
is no fallback."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "arroyo_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from csrc/ at first use")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libarroyo_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernel library unless it is already built;
    returns its path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept in ``build.log`` beside
    the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = out.stem.rsplit("-", 1)[1]
    sources = sorted(CSRC_DIR.glob("*.cu"))
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *[str(o) for _, o, _ in procs], "-o",
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (building it first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch(what: str, fn, device: torch.device, *args) -> None:
    """Launch a kernel: call its C launcher ``fn(*args, stream)`` on
    PyTorch's current stream of ``device`` and raise on a non-zero
    ``cudaError_t``.  It enters no device context and builds no
    ``torch.cuda.Stream`` object (the raw handle is the one PyTorch's
    generated code reads), so ``device`` must already be the current
    device, else it raises.  Every wrapper launches through here."""
    index = device.index
    current = torch._C._cuda_getDevice()
    if index != current:
        raise ValueError(f"{what}: tensors on cuda:{index} but cuda:{current} "
                         "is the current device")
    check(fn(*args, torch._C._cuda_getCurrentRawStream(index)), what)
