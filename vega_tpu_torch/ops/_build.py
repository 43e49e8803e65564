"""Build and load the port's CUDA kernels.

The sources under `vega_tpu_torch/csrc/` are compiled with nvcc into one
shared library with a plain C interface and loaded with ctypes. The build
runs at first use, into `build/vega_tpu_torch/` at the repo root (listed
in .gitignore), under a file name keyed on a hash of the sources and
flags: editing a kernel rebuilds it, and a fresh checkout builds from its
own sources. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

from ..utils import REPO_ROOT

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = REPO_ROOT / 'build' / 'vega_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    built: bool          # False when a matching build was already on disk
    log: str             # nvcc / ptxas output of the build


def _sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def _nvcc():
    """nvcc from CUDA_HOME, else PATH, else the toolkit's default
    install location."""
    cuda_home = os.environ.get('CUDA_HOME')
    candidates = [Path(cuda_home) / 'bin' / 'nvcc'] if cuda_home else []
    found = shutil.which('nvcc')
    if found:
        candidates.append(Path(found))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for cand in candidates:
        if cand.is_file():
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels of '
                       'vega_tpu_torch are built from source at first use')


def _build_key():
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _declare(lib):
    ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double)
    signatures = {
        # knots, y, m, x, leg, out, B, L, N, M, G, tiles, tile_q, x / leg
        # row strides, step, order, stream
        'vega_spline_legendre_combine_f64':
            [ptr] * 6 + [i32] * 7 + [i64, i64, f64, i32, ptr],
        # knots, y, m, x, out, B, L, N, M, G, tiles, tile_q, x row stride,
        # step, order, stream
        'vega_spline_legendre_points_f64':
            [ptr] * 5 + [i32] * 7 + [i64, f64, i32, ptr],
        # knots, g, x, leg, out_y, out_m, scratch, B, L, N, M, tiles,
        # tile_q, x / leg row strides, step, order, stream
        'vega_spline_legendre_transpose_f64':
            [ptr] * 7 + [i32] * 6 + [i64, i64, f64, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.vega_cuda_error_string.argtypes = [i32]
    lib.vega_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    path = BUILD_DIR / f'libvega_tpu_torch_kernels_{_build_key()}.so'
    if path.is_file():
        return KernelLibrary(_declare(ctypes.CDLL(str(path))), path,
                             built=False, log='')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [str(_nvcc()), *NVCC_FLAGS, '-o', tmp,
           *(str(s) for s in _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{log}')
    os.replace(tmp, path)   # atomic: a concurrent load never sees a partial file
    return KernelLibrary(_declare(ctypes.CDLL(str(path))), path,
                         built=True, log=log)
