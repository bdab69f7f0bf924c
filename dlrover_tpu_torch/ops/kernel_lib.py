"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, loaded through ``ctypes``.  No
PyTorch headers are involved, so a build takes seconds, not minutes.

Libraries land in ``build/kernels/`` beside the package, named by the
source and a hash of its bytes, the bytes of every shared header
(``csrc/*.cuh``) and the flags: a changed source or header builds anew,
an unchanged one loads.  A build happens at first use (or through
:func:`build_all`, which starts one ``nvcc`` per source at once).  A
missing ``nvcc`` or a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "build", "kernels",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: SMs of an H100 SXM; the launch plans take the card's own count
#: (:func:`num_sms`).
H100_SMS = 132

# name -> loaded library; name -> compiler output of the build (ptxas
# register/shared-memory report), empty when the library was cached.
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(
        f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    sha = hashlib.sha256()
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            sha.update(f.read())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{sha.hexdigest()[:16]}.so")


def build_all(names: List[str] = None) -> float:
    """Compile every kernel library not yet built, one ``nvcc`` process
    per source, all started together.  Returns wall seconds."""
    t0 = time.perf_counter()
    names = sources() if names is None else names
    todo = []
    for name in names:
        src, out = _target(name)
        if not os.path.exists(out):
            todo.append((name, src, out))
    if todo:
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name, src, out in todo:
            tmp = f"{out}.{os.getpid()}.tmp"
            procs.append((name, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError(
                "nvcc failed to build kernel libraries:\n" + "\n".join(failed)
            )
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _, out = _target(name)
        if not os.path.exists(out):
            build_all([name])
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """SMs of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
