"""Build and load the CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
library file is named by a hash of its source and the flags, so a changed
source rebuilds; builds land in ``repro_torch/_build`` (git-ignored). The
build happens at first use, never at import: the CPU-only test suite imports
every module and has no ``nvcc``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("minplus", "forest", "walk", "flash_attention", "ssd", "nsga2")
#: The sources of the NoC kernels K1-K4 and of NSGA-II's selection, which
#: the searches on a card run.
NOC_SOURCES = ("minplus", "forest", "walk", "nsga2")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ``-Xptxas -v`` output per source, from the build that produced the
#: loaded library (empty when the library was already on disk).
ptxas_log: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built with the CUDA toolkit at first use")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, float]:
    """Compile every source among ``names`` that is not yet built, one
    ``nvcc`` per source, all started together. Returns the wall seconds per
    source built."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    secs = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        ptxas_log[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def load(names: tuple[str, ...]) -> None:
    """Build the missing libraries among ``names`` together and load them.
    A coordinator calls this before it starts worker processes, so that
    each child only loads the libraries and no child starts ``nvcc``."""
    with _lock:
        build_all(tuple(n for n in names if n not in _libs))
    for name in names:
        library(name)


def sass_counts(name: str, opcodes=("HMMA", "HGMMA")) -> dict[str, int]:
    """How many instructions of each opcode the SASS of the built library
    for ``csrc/<name>.cu`` holds (``cuobjdump -sass``): tensor-core
    instructions are ``HMMA`` (``mma.sync``) and ``HGMMA`` (``wgmma``)."""
    library(name)
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}
