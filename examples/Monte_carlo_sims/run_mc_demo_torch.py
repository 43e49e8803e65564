"""Monte-Carlo simulations with the PyTorch port (vega_tpu_torch) on the
GPU — runnable demo.

Counterpart of run_mc_demo.py in this directory: the MPI rank fan-out of
the reference becomes the device-batched engine: all mocks are generated
(fiducial + Cholesky noise) and fitted at once, the fits sharded over
the device mesh (every card; on a one-card host a mesh of that card).

Two ways to run MC campaigns:

1. Config-driven (reference-compatible): a main.ini with
   [control] run_montecarlo = True, num_mc_mocks = N, plus the
   [monte carlo] / [mc parameters] sections, run through
   `python -m vega_tpu_torch.scripts.run_vega_mc main.ini
   [--n-devices N]` — the batched engine, or with --sequential the
   reference's loop.

2. API-driven (this demo): MonteCarloEngine directly.

Run:  python run_mc_demo_torch.py [--device cpu] [--mocks N]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse   # noqa: E402
import tempfile   # noqa: E402

import numpy as np   # noqa: E402
import torch         # noqa: E402

from vega_tpu_torch.parallel import (MonteCarloEngine,  # noqa: E402
                                     make_device_mesh)
from vega_tpu_torch.testing import make_synthetic_dataset   # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface     # noqa: E402

NUM_MOCKS = 32


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    pars.add_argument('--mocks', type=int, default=NUM_MOCKS)
    args = pars.parse_args(argv)
    num_mocks = args.mocks

    workdir = tempfile.mkdtemp(prefix='vega_mc_demo_')
    vega = VegaInterface(make_synthetic_dataset(workdir, cross=True,
                                                size='tiny',
                                                device=args.device),
                         device=args.device)

    # The fiducial: the model at the parameters mocks should be drawn
    # from (the reference reads these from [mc parameters] / a saved
    # fit; vega.get_fiducial_for_monte_carlo does the same here)
    fiducial = vega.compute_model(run_init=False)

    vega.monte_carlo = True
    mesh = (make_device_mesh() if torch.device(args.device).type == 'cuda'
            else make_device_mesh(devices=[args.device]))
    engine = MonteCarloEngine(vega, mesh=mesh)

    # Generate ALL mocks on the device: fiducial + L @ N(0,1) per
    # realization
    mocks = engine.generate_mocks(fiducial, num_mocks=num_mocks, seed=42)

    # Fit ALL mocks at once (batched damped-Newton, exact gradients /
    # Hessians, sharded over the mesh)
    results = engine.fit_mocks(mocks, sample_params=vega.sample_params,
                               max_iterations=100)

    valid = results['valid']
    print(f'{int(valid.sum())}/{num_mocks} valid fits')
    pulls_by_name = {}
    for i, name in enumerate(results['names']):
        vals = results['values'][valid, i]
        errs = results['errors'][valid, i]
        truth = vega.params[name]
        pulls = (vals - truth) / errs
        pulls_by_name[name] = (float(pulls.mean()), float(pulls.std()))
        print(f'{name}: ensemble mean {vals.mean():+.5f} (truth '
              f'{truth:+.5f}), pull mean {pulls.mean():+.2f}, pull std '
              f'{pulls.std():.2f}')

    # Pull distribution ~ N(0, 1) validates both the mock generation and
    # the error bars from the batched Hessians.
    pull = float(np.mean((results['values'][valid]
                          - [vega.params[n] for n in results['names']])
                         / results['errors'][valid]))
    assert abs(pull) < 0.5
    print('MC demo OK')
    return {'valid': int(valid.sum()), 'pull_mean': pull,
            'pulls': pulls_by_name,
            'errors': results['errors'].mean(0).tolist(),
            'truth': [float(vega.params[n]) for n in results['names']]}


if __name__ == '__main__':
    main()
