"""Fused supersample -> Chebyshev deficit -> chi^2 for one draw chunk.

Counterpart of the JAX package's ``ops/pallas_core.py::chi2_supersampled``
(the v2 schedule) and ``chi2_supersampled_v3`` (the time-major v3
schedule). On a CUDA tensor each launches its hand-written kernel in
``csrc/chi2_supersampled.cu`` (built with nvcc for sm_90a at first use and
loaded with ctypes); on a CPU tensor each runs ``chi2_supersampled_plain``,
the same arithmetic in plain torch. There is no fallback between them.

``launches`` and ``launches_v3`` count kernel launches (not plain-path
calls), so a run can show that its main path went through a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from .fastcore import M_CHEB, cheb_deficit_eval

DRAW_TILE = 256     # v2: C % DRAW_TILE == 0
DRAW_LANES = 128    # v3: C % DRAW_LANES == 0
MAX_NODES = 4

launches = 0
launches_v3 = 0

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("chi2_supersampled.cu",)
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-prec-sqrt=true", "-prec-div=true", "-ftz=false")

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def library_path() -> Path:
    """Shared library path, keyed by a hash of the sources and flags so an
    edited ``.cu`` file is rebuilt."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"libchi2_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    so = library_path()
    if so.exists() and not verbose:
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(_CSRC / n) for n in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn in (lib.chi2_supersampled_launch,
                   lib.chi2_supersampled_v3_launch):
            fn.argtypes = ([ctypes.c_void_p] * 11
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, offs, wgts,
           tile):
    if q0.dim() != 2:
        raise ValueError(f"q0 must be (C, n_t), got {tuple(q0.shape)}")
    C, n_t = q0.shape
    if C % tile:
        raise ValueError(f"chunk {C} must be a multiple of {tile}")
    shapes = dict(q0=(C, n_t), q1=(C, n_t), q2=(C, n_t), front=(C, n_t),
                  cA=(C, M_CHEB), cB1=(C, M_CHEB), cB2=(C, M_CHEB),
                  seg=(C, 5), g=(C, 1), obs_dev=(1, n_t))
    arrs = dict(q0=q0, q1=q1, q2=q2, front=front, cA=cA, cB1=cB1, cB2=cB2,
                seg=seg, g=g, obs_dev=obs_dev)
    for name, a in arrs.items():
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shapes[name]}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != q0.device:
            raise ValueError(f"{name} is on {a.device}, q0 on {q0.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= len(offs) <= MAX_NODES) or len(offs) != len(wgts):
        raise ValueError(f"need 1..{MAX_NODES} offsets with one weight "
                         f"each, got {len(offs)} and {len(wgts)}")


def chi2_supersampled_plain(q0, q1, q2, front, cA, cB1, cB2, seg, g,
                            obs_dev, *, offs, wgts):
    """Plain torch version of both kernels (any device): the same function
    as ``chi2_supersampled`` and ``chi2_supersampled_v3``, on draw-major
    inputs. It evaluates every point; the kernels skip groups of points
    that are out of transit (v2: 32 time points of one draw; v3: 32 draws
    x 8 time points), which drops their ~1e-8 deficit residue at
    z >= zmax."""
    coeffs = (cA, cB1, cB2, *seg.unbind(1))
    Dbar = torch.zeros_like(q0)
    for d, wt in zip(offs, wgts):
        z = torch.sqrt(torch.clamp_min(q0 + q1 * d + q2 * (d * d), 0.0))
        Dbar = Dbar + wt * cheb_deficit_eval(coeffs, z)
    gD = g * (Dbar * front)
    return torch.sum(gD * (2.0 * obs_dev + gD), dim=1) + torch.sum(
        obs_dev * obs_dev)


def _launch(name, planes, cA, cB1, cB2, seg, g, obs_dev, C, n_t, offs,
            wgts):
    """Launch one kernel of the library on the current stream; raises if
    the launch is refused."""
    lib = _load()
    out = torch.empty((C,), dtype=torch.float32, device=cA.device)
    offs_h = (ctypes.c_float * len(offs))(*offs)
    wgts_h = (ctypes.c_float * len(wgts))(*wgts)
    with torch.cuda.device(cA.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            *(p.data_ptr() for p in planes), cA.data_ptr(), cB1.data_ptr(),
            cB2.data_ptr(), seg.data_ptr(), g.data_ptr(), obs_dev.data_ptr(),
            out.data_ptr(), C, n_t, ctypes.addressof(offs_h),
            ctypes.addressof(wgts_h), len(offs), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def _nodes(offs, wgts):
    return tuple(float(o) for o in offs), tuple(float(w) for w in wgts)


def _device_path(q0):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if q0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no chi2 kernel for device {q0.device}")
    return q0.device.type == "cuda"


def chi2_supersampled(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, *,
                      offs, wgts):
    """chi^2 (unnormalized by sigma) for one draw chunk, v2 schedule.

    Args (all float32, contiguous, on one device):
        q0, q1, q2: (C, n_t) per-exposure quadratic z^2 model.
        front: (C, n_t) visibility gate (0/1).
        cA, cB1, cB2: (C, 18) Chebyshev deficit coefficients per segment.
        seg: (C, 5) [zsplit, zmid, invA, invB1, invB2].
        g: (C, 1) dilution multiplier.
        obs_dev: (1, n_t) observed flux - 1.
        offs, wgts: exposure quadrature nodes and weights (1 to 4 floats).
    Returns:
        (C,) sum of squared residuals (divide by sigma^2 outside).
    C must be a multiple of 256. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel.
    """
    global launches
    offs, wgts = _nodes(offs, wgts)
    _check(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, offs, wgts,
           DRAW_TILE)
    if not _device_path(q0):
        return chi2_supersampled_plain(q0, q1, q2, front, cA, cB1, cB2, seg,
                                       g, obs_dev, offs=offs, wgts=wgts)
    out = _launch("chi2_supersampled", (q0, q1, q2, front), cA, cB1, cB2,
                  seg, g, obs_dev, *q0.shape, offs, wgts)
    launches += 1
    return out


def time_major(q0, q1, q2, front):
    """The four (C, n_t) planes as contiguous time-major (n_t, C) tensors,
    the layout the v3 kernel reads."""
    return tuple(p.t().contiguous() for p in (q0, q1, q2, front))


def launch_v3(planes_t, cA, cB1, cB2, seg, g, obs_dev, *, offs, wgts):
    """Launch the v3 kernel on time-major planes (``time_major``); CUDA
    tensors already checked by ``chi2_supersampled_v3``."""
    global launches_v3
    offs, wgts = _nodes(offs, wgts)
    n_t, C = planes_t[0].shape
    out = _launch("chi2_supersampled_v3", planes_t, cA, cB1, cB2, seg, g,
                  obs_dev, C, n_t, offs, wgts)
    launches_v3 += 1
    return out


def chi2_supersampled_v3(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev,
                         *, offs, wgts):
    """chi^2 for one draw chunk, v3 schedule: the same arguments, checks
    and result as ``chi2_supersampled``, with C a multiple of 128. On a
    CUDA tensor the four planes are transposed to time-major here and the
    time-major kernel is launched; a CPU tensor runs the plain version."""
    offs, wgts = _nodes(offs, wgts)
    _check(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, offs, wgts,
           DRAW_LANES)
    if not _device_path(q0):
        return chi2_supersampled_plain(q0, q1, q2, front, cA, cB1, cB2, seg,
                                       g, obs_dev, offs=offs, wgts=wgts)
    return launch_v3(time_major(q0, q1, q2, front), cA, cB1, cB2, seg, g,
                     obs_dev, offs=offs, wgts=wgts)
