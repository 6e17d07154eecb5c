"""Build and load the port's CUDA kernels (``rvos_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded through ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries go to
``rvos_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt at its next use.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers of
    ``csrc/`` and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every missing library of ``names``, one ``nvcc`` per
    source, all started together; raises with the compiler's output if
    any fails.  The ptxas report (registers, shared memory, spills) of
    each build is kept beside the library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for n, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, p)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
