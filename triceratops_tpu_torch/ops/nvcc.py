"""nvcc builds of the port's CUDA libraries.

Each library (``chi2_core``'s ``libchi2``, ``sampler_kernels``'
``libsamplers``) is compiled from ``csrc/`` for sm_90a at first use into
``_build/lib<stem>_<hash>.so`` and loaded with ctypes by its module. The
hash covers the sources and ``NVCC_FLAGS``, so an edited ``.cu`` file is
rebuilt; ``build.<stem>`` of ``utils/profiling.py`` counts the builds.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

from ..utils import profiling

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-prec-sqrt=true", "-prec-div=true", "-ftz=false")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def library_file(stem, sources) -> Path:
    """The library path of ``csrc/<sources>``, keyed by a hash of the
    sources and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources:
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_library(stem, sources, verbose: bool = False) -> Path:
    """Compile ``csrc/<sources>`` into ``_build/lib<stem>_<hash>.so`` if it
    is not built yet, counting the build under ``build.<stem>``; returns
    its path. ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    report."""
    so = library_file(stem, sources)
    if so.exists() and not verbose:
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(_CSRC / n) for n in sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    profiling.count(f"build.{stem}")
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, so)
    return so
