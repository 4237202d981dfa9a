"""Build C++ sources for this package: the repo's shared `native/*.cpp` and
the package's own `csrc/*.cpp`.

The JAX package keeps its own builds beside the sources in `native/`; this
package never loads those. It compiles each source with g++ into
`lancet2_tpu_torch/_build/native/<hash>/`, where the hash covers the source,
the flags and the host's CPU flags (the build uses `-march=native`, so a
library built on one host is not reused on another). The library is written
under a temporary name and renamed into place, so processes that build at
the same time never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def build_library(source: str, src_dir: str = NATIVE_SRC) -> str:
    """Compile `<src_dir>/<source>` (once per source, flags and CPU) and
    return the path of the shared library. Raises when g++ fails."""
    src = os.path.join(src_dir, source)
    with open(src, "rb") as f:
        code = f.read()
    key = hashlib.sha256(code + " ".join(CXX_FLAGS).encode() + _cpu_flags())
    out_dir = os.path.join(BUILD_DIR, key.hexdigest()[:16])
    so = os.path.join(out_dir, os.path.splitext(source)[0] + ".so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so
