"""Process-wide settings for the PyTorch tests, made before any test runs.

One intra-op thread per test process, for torch and for numpy's BLAS.
Tier-1 runs the tests in six worker processes on the host's cores, and
torch's default of one intra-op thread per core in every process
oversubscribes them: a test file of the port then takes about 2.5 times
the CPU time it takes with one thread, and no less wall time. The results
do not depend on the thread count (the port's reductions over a tensor
give the same sums at 1, 3 and 8 threads). OpenBLAS, whose threads spin
while they wait, is worse: with five other busy processes on the host
the host-layer tests of tests/test_torch_marginalization.py took 173.6 s
at its default of a thread per core and 7.5 s on one.

vega_tpu's pair histograms from a library of this process's own. vega_tpu
builds its C++ pair histograms (vega_tpu/native/pair_hist.py) at first
use into $HOME/.cache/vega_tpu_native by running g++ straight onto the
library's path, and a process that finds that file half written fails
to load it and computes the new-metals matrices in numpy for the rest of
its life, silently. With a fresh HOME, the six workers race for that
file; a worker that loses builds its vega_tpu datasets and evaluations
on the numpy matrices, which are not the C++ ones to the last bits
(tests/test_torch_new_metals.py holds the two routes to 1e-8), and the
tiny DESI mock's dense chi^2 then misses vega_tpu's committed numbers by
2.2e-11 against the 1e-12 gate.
So the PyTorch tests point vega_tpu's loader at a library built here
atomically (a temporary file renamed into place), keyed on vega_tpu's
source, the flags and the CPU model, and fail loudly if it does not
load. vega_tpu itself is not edited.

Every tests/test_torch_*.py module imports this before it runs a test;
the settings are the same in all of them, whichever module a worker
imports first.
"""

import torch
from threadpoolctl import threadpool_limits

torch.set_num_threads(1)
threadpool_limits(limits=1, user_api='blas')


def pin_jax_pair_hist():
    """Build vega_tpu's pair-histogram library atomically into the port's
    build directory (vega_tpu_torch.native.pair_hist.build_library) and
    make vega_tpu load that one (raising if it cannot)."""
    from vega_tpu.native import pair_hist as jax_pair_hist
    from vega_tpu_torch.native.pair_hist import build_library

    path = build_library(jax_pair_hist._SRC, 'libvega_tpu_pair_hist')
    jax_pair_hist._build_library = lambda: path
    jax_pair_hist._LIB, jax_pair_hist._TRIED = None, False
    if not jax_pair_hist.native_available():
        raise RuntimeError(f"vega_tpu's pair histograms did not load from "
                           f'{path}')


pin_jax_pair_hist()
