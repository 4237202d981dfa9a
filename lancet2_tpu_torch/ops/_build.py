"""Build the port's CUDA kernels with nvcc at first use, load them, and count
their launches.

Every `csrc/*.cu` is compiled to an object by its own nvcc, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
`lancet2_tpu_torch/_build/<hash>/`, where the hash covers the sources and the
flags. The library is loaded with ctypes. A failed build raises: there is no
fallback to the plain versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}

# Launch counts, one per kernel wrapper: bumped only where a kernel is
# launched (`count_launch`), never by a plain version. Several host threads
# launch at once under the threads executor, so every update holds a lock.
LAUNCHES = {"span": 0, "evidence": 0, "sw_fitting": 0}
_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build "
                           "the CUDA kernels")
    return path


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _run_all(cmds: list[list[str]], log) -> None:
    """Run the commands at the same time; raise if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.write(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(cmd[-1])} "
                          f"({proc.returncode}):\n{out[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in srcs:
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + f.read())
        out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
        so = os.path.join(out_dir, "liblancet2_kernels.so")
        t0 = time.monotonic()
        built = False
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            nvcc, tag = _nvcc(), os.getpid()
            cus = [s for s in srcs if s.endswith(".cu")]
            objs = [os.path.join(out_dir, os.path.basename(s) + f".{tag}.o")
                    for s in cus]
            with open(os.path.join(out_dir, "nvcc.log"), "w") as log:
                _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                          for s, o in zip(cus, objs)], log)
                tmp = f"{so}.{tag}.tmp"
                _run_all([[nvcc, "-shared", "-o", tmp, *objs]], log)
            os.replace(tmp, so)
            built = True
        _lib = ctypes.CDLL(so)
        BUILD_INFO.update(path=so, built=built,
                          seconds=time.monotonic() - t0)
        return _lib
