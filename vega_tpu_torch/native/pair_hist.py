"""ctypes bindings for the C++ pair-histogram kernels of the new-metals
distortion matrices (metals.py).

Counterpart of vega_tpu/native/pair_hist.py with the same C interface.
The library is compiled with g++ at first use into `build/vega_tpu_torch/`
at the repo root (listed in .gitignore), under a file name keyed on a
hash of the source, the flags and the CPU model (-march=native), as
ops/_build.py does for nvcc. A build
that fails raises: nothing falls back to numpy unless the caller asks
for the numpy route (`Metals.compute_metal_dmat(..., route='numpy')`).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / 'pair_hist.cpp'
GXX_FLAGS = ('-O3', '-march=native', '-fopenmp', '-shared', '-fPIC')


def _cpu_model():
    """The host CPU's model name: -march=native builds for it, so a
    library built on another CPU is not reused."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _build_key():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(' '.join(GXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    return h.hexdigest()[:16]


def _declare(lib):
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.pair_histograms.argtypes = (
        [dptr] * 5 + [ctypes.c_int64]      # tracer 1
        + [dptr] * 5 + [ctypes.c_int64]    # tracer 2
        + [ctypes.c_int, ctypes.c_double, ctypes.c_double,
           ctypes.c_double, ctypes.c_double, ctypes.c_int64,
           ctypes.c_double, ctypes.c_double, ctypes.c_int64,
           ctypes.c_double]
        + [dptr] * 6)
    lib.pair_histograms.restype = None
    lib.pair_ratio_range.argtypes = (
        [dptr, dptr, ctypes.c_int64, dptr, dptr, ctypes.c_int64,
         dptr, dptr])
    lib.pair_ratio_range.restype = None
    return lib


@functools.cache
def load_library():
    """Build (if needed) and load the library; cached per process.
    Raises RuntimeError when g++ is missing or the build fails."""
    path = BUILD_DIR / f'libvega_tpu_torch_pair_hist_{_build_key()}.so'
    if path.is_file():
        return _declare(ctypes.CDLL(str(path)))
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ not found: the pair histograms of the '
                           'new-metals matrices are built from source at '
                           'first use')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, str(SOURCE), '-o', tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'g++ failed ({proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)   # atomic: a concurrent load sees no partial file
    return _declare(ctypes.CDLL(str(path)))


def _as_c(arr):
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def pair_ratio_range(true_r1, assumed_r1, true_r2, assumed_r2):
    """(min, max) of (assumed_r1 + assumed_r2) / (true_r1 + true_r2) over
    all pairs (the range of the distance-ratio histogram)."""
    tr1, tr1_p = _as_c(true_r1)
    ar1, ar1_p = _as_c(assumed_r1)
    tr2, tr2_p = _as_c(true_r2)
    ar2, ar2_p = _as_c(assumed_r2)
    out_min = ctypes.c_double()
    out_max = ctypes.c_double()
    load_library().pair_ratio_range(
        tr1_p, ar1_p, len(tr1), tr2_p, ar2_p, len(tr2),
        ctypes.byref(out_min), ctypes.byref(out_max))
    return out_min.value, out_max.value


def pair_histograms(true_r1, assumed_r1, true_z1, assumed_z1, w1,
                    true_r2, assumed_r2, true_z2, assumed_z2, w2,
                    abs_rp, zmin, zmax, rp_edges, ratio_edges,
                    rp_ratio_cut=20.0):
    """Streamed pair histograms; see pair_hist.cpp for definitions.

    Returns (h2, sum_true, sum_assumed, sum_assumed_rp, sum_z, ratio_hist).
    """
    lib = load_library()
    tr1, tr1_p = _as_c(true_r1)
    ar1, ar1_p = _as_c(assumed_r1)
    tz1, tz1_p = _as_c(true_z1)
    az1, az1_p = _as_c(assumed_z1)
    ww1, w1_p = _as_c(w1)
    tr2, tr2_p = _as_c(true_r2)
    ar2, ar2_p = _as_c(assumed_r2)
    tz2, tz2_p = _as_c(true_z2)
    az2, az2_p = _as_c(assumed_z2)
    ww2, w2_p = _as_c(w2)

    rp_edges = np.asarray(rp_edges, dtype=np.float64)
    n_rp = len(rp_edges) - 1
    if ratio_edges is not None:
        ratio_edges = np.asarray(ratio_edges, dtype=np.float64)
        n_ratio = len(ratio_edges) - 1
        ratio_min, ratio_max = float(ratio_edges[0]), float(ratio_edges[-1])
    else:
        n_ratio = 0
        ratio_min = ratio_max = 0.0

    h2 = np.zeros((n_rp, n_rp))
    sum_true = np.zeros(n_rp)
    sum_assumed = np.zeros(n_rp)
    sum_assumed_rp = np.zeros(n_rp)
    sum_z = np.zeros(n_rp)
    ratio_hist = np.zeros(max(n_ratio, 1))

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    lib.pair_histograms(
        tr1_p, ar1_p, tz1_p, az1_p, w1_p, len(tr1),
        tr2_p, ar2_p, tz2_p, az2_p, w2_p, len(tr2),
        int(abs_rp), float(zmin), float(zmax),
        float(rp_edges[0]), float(rp_edges[-1]), n_rp,
        ratio_min, ratio_max, n_ratio, float(rp_ratio_cut),
        ptr(h2), ptr(sum_true), ptr(sum_assumed), ptr(sum_assumed_rp),
        ptr(sum_z), ptr(ratio_hist))

    return (h2, sum_true, sum_assumed, sum_assumed_rp, sum_z,
            ratio_hist[:n_ratio] if n_ratio else None)
