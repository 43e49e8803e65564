"""The port's pair histograms (vega_tpu_torch/native/pair_hist.cpp) give
the same bits at any OpenMP thread count and on every call, and agree
with vega_tpu's copy (vega_tpu/native/pair_hist.cpp) run on one thread.

vega_tpu's copy adds per-thread partials filled under a dynamic
schedule, so its sums move with the thread count and from run to run;
the port sums a fixed set of row partitions in order. Each call runs in
a fresh subprocess, so that OMP_NUM_THREADS takes effect before the
OpenMP runtime starts. Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUTPUTS = ('h2', 'sum_true', 'sum_assumed', 'sum_assumed_rp', 'sum_z',
           'ratio_hist')
# the two copies add the same pair weights in another grouping (the
# port's row partitions against one running sum): of each output's
# largest entry
COPY_RTOL = 1e-13

SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    package, out = sys.argv[1], sys.argv[2]
    if package == 'port':
        from vega_tpu_torch.native import pair_hist
    else:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        # vega_tpu's library from the atomic build (tests/torch_threads.py)
        sys.path.insert(0, 'tests')
        import torch_threads  # noqa: F401
        from vega_tpu.native import pair_hist
    rng = np.random.default_rng(11)
    n1 = n2 = 3000
    true_z1, true_z2 = rng.uniform(1.8, 3.5, n1), rng.uniform(1.8, 3.5, n2)
    assumed_z1 = true_z1 * rng.uniform(0.97, 1.03, n1)
    assumed_z2 = true_z2 * rng.uniform(0.97, 1.03, n2)
    w1, w2 = rng.uniform(0, 2, n1), rng.uniform(0, 2, n2)
    dist = lambda z: 3000 * np.log(1 + z)
    runs = [pair_hist.pair_histograms(
        dist(true_z1), dist(assumed_z1), true_z1, assumed_z1, w1,
        dist(true_z2), dist(assumed_z2), true_z2, assumed_z2, w2,
        0, 2.0, 3.2, np.linspace(-200, 200, 101),
        np.linspace(0.9, 1.1, 41)) for _ in range(2)]
    np.savez(out, **{f'{k}_{i}': a for i, run in enumerate(runs)
                     for k, a in zip(%r, run)})
''' % (OUTPUTS,))


def run_pair_histograms(package, threads, out):
    """pair_histograms of `package` ('port' or 'jax') on the seeded 3,000
    x 3,000 pairs, called twice in a fresh process at `threads` OpenMP
    threads: {output name: [first call, second call]}."""
    env = dict(os.environ, OMP_NUM_THREADS=str(threads), JAX_PLATFORMS='cpu')
    subprocess.run([sys.executable, '-c', SCRIPT, package, str(out)],
                   cwd=REPO, env=env, check=True)
    with np.load(out) as f:
        return {k: [f[f'{k}_0'], f[f'{k}_1']] for k in OUTPUTS}


def test_pair_histograms_same_bits_at_any_thread_count(tmp_path):
    """Two processes at OMP_NUM_THREADS=1 and two at 8, each calling
    twice: every output is the same bits in all eight calls."""
    runs = [run_pair_histograms('port', threads, tmp_path / f'{threads}_{i}.npz')
            for threads in (1, 8) for i in range(2)]
    for name in OUTPUTS:
        want = runs[0][name][0]
        assert np.any(want != 0), name
        for run in runs:
            for got in run[name]:
                assert got.tobytes() == want.tobytes(), name


def test_pair_histograms_match_jax_copy_on_one_thread(tmp_path):
    """The port's sums against vega_tpu's copy at OMP_NUM_THREADS=1,
    where its dynamic schedule runs every row on one thread in order
    (COPY_RTOL)."""
    got = run_pair_histograms('port', 1, tmp_path / 'port.npz')
    want = run_pair_histograms('jax', 1, tmp_path / 'jax.npz')
    for name in OUTPUTS:
        ref = want[name][0]
        assert want[name][1].tobytes() == ref.tobytes(), name
        assert (np.max(np.abs(got[name][0] - ref))
                <= COPY_RTOL * np.max(np.abs(ref))), name
