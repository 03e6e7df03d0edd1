"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch
headers), so one ``nvcc`` call per source takes seconds. Libraries are
built at first use into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags:
an edited source is rebuilt, an unchanged one is loaded as it is. A
build writes a temporary file and renames it into place, so concurrent
processes never load a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list:
    """Names of every CUDA source of the package (``csrc/*.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers too: an edited header rebuilds every source
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns
    ``{name: {"path", "seconds", "log"}}``; ``log`` holds what ptxas
    printed (registers, shared memory, spills). Raises with the
    compiler's output if any build fails."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "log": "cached"}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"path": str(lib), "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]["path"]
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
