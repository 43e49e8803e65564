"""Tutorial 6 — Batched likelihoods, samplers, Monte-Carlo campaigns,
with the PyTorch port (vega_tpu_torch) on the GPU.

Counterpart of examples/tutorials/06_samplers_and_batching.py, the
replacement for the reference's MPI fan-outs: parameter batches shard
over a device mesh (every card; on a one-card host a mesh of that card),
the native nested / SMC samplers drive the batched likelihood, and mock
campaigns fit every realization at once.

Run:  python 06_samplers_and_batching.py [--device cpu]
      [--num-live N] [--hmc-chains N] [--hmc-samples N] [--hmc-warmup N]
      [--mocks N]    (defaults: the original tutorial's settings)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse       # noqa: E402
import configparser   # noqa: E402
import tempfile       # noqa: E402

import numpy as np   # noqa: E402
import torch         # noqa: E402

from vega_tpu_torch.parallel import (BatchedLikelihood,  # noqa: E402
                                     MonteCarloEngine, make_device_mesh)
from vega_tpu_torch.samplers.hmc import HMC                 # noqa: E402
from vega_tpu_torch.samplers.nested import NestedSampler    # noqa: E402
from vega_tpu_torch.testing import make_synthetic_dataset   # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface     # noqa: E402


def mesh_for(device):
    """Every card for a card; the CPU listed once for the CPU."""
    if torch.device(device).type == 'cuda':
        return make_device_mesh()
    return make_device_mesh(devices=[device])


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    pars.add_argument('--num-live', type=int, default=100)
    pars.add_argument('--hmc-chains', type=int, default=16)
    pars.add_argument('--hmc-samples', type=int, default=400)
    pars.add_argument('--hmc-warmup', type=int, default=200)
    pars.add_argument('--mocks', type=int, default=32)
    args = pars.parse_args(argv)

    workdir = Path(tempfile.mkdtemp(prefix='vega_tutorial_'))
    vega = VegaInterface(make_synthetic_dataset(workdir, cross=False,
                                                size='tiny',
                                                device=args.device),
                         device=args.device)

    # --- 1. Batched likelihood over a device mesh ----------------------
    mesh = mesh_for(args.device)           # all local devices, 1D
    bl = BatchedLikelihood(vega, mesh=mesh)
    batch = {'bias_LYA': np.linspace(-0.13, -0.10, 64),
             'beta_LYA': np.full(64, 1.67)}
    chi2 = bl.chi2(batch).cpu().numpy()
    print(f'64 chi^2 values in one sharded call: '
          f'min {chi2.min():.2f} at bias = '
          f'{batch["bias_LYA"][chi2.argmin()]:+.4f}')

    # --- 2. Native nested sampling (posterior + evidence) --------------
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['s'] = {'path': str(workdir), 'name': 'demo',
                   'num_live': str(args.num_live),
                   'num_repeats': '6', 'precision': '0.05',
                   'resume': 'False'}
    limits = {'bias_LYA': (-0.15, -0.09), 'beta_LYA': (1.3, 2.1)}
    ns = NestedSampler(config['s'], limits, bl.log_lik)
    ns_results = ns.run()
    mean = np.average(ns_results['samples'], axis=0,
                      weights=ns_results['weights'])
    print(f'NS: logZ = {ns_results["logz"]:.2f}, posterior mean '
          f'bias = {mean[0]:+.4f}, beta = {mean[1]:.3f}')
    # (chains land in getdist-compatible demo.txt / demo.paramnames)

    # --- 2b. Exact-gradient HMC (posterior; no evidence) ---------------
    # The chi^2 is differentiable end to end (autograd through the
    # kernels), so HMC gets exact gradients and each trajectory runs on
    # the device (one CUDA graph on a card, chains batched).
    config['h'] = {'path': str(workdir), 'name': 'demo_hmc',
                   'num_chains': str(args.hmc_chains),
                   'num_samples': str(args.hmc_samples),
                   'num_warmup': str(args.hmc_warmup), 'num_leapfrog': '10'}
    hmc = HMC(config['h'], limits, bl)
    hmc_results = hmc.run()
    print(f'HMC: accept {hmc_results["accept_rate"]:.2f}, '
          f'max R-hat {hmc_results["r_hat"].max():.3f}, '
          f'mean bias = {hmc_results["samples"][:, 0].mean():+.4f}')

    # --- 3. Monte-Carlo campaign: generate + fit all mocks at once -----
    fiducial = vega.compute_model(run_init=False)
    vega.monte_carlo = True
    engine = MonteCarloEngine(vega, mesh=mesh)
    mocks = engine.generate_mocks(fiducial, num_mocks=args.mocks, seed=1)
    fits = engine.fit_mocks(mocks, sample_params=vega.sample_params,
                            max_iterations=50)
    ok = int(np.sum(fits['valid']))
    print(f'MC campaign: {ok}/{args.mocks} valid fits, '
          f'<bias> = {fits["values"][:, 0].mean():+.4f} '
          f'(truth {vega.params["bias_LYA"]:+.4f})')
    return {'chi2': chi2.tolist(), 'ns_logz': float(ns_results['logz']),
            'ns_logz_err': float(ns_results['logz_err']),
            'ns_mean': mean.tolist(),
            'hmc_accept': float(hmc_results['accept_rate']),
            'hmc_r_hat': float(np.max(hmc_results['r_hat'])),
            'hmc_mean': np.asarray(hmc_results['samples']).mean(0).tolist(),
            'hmc_std': np.asarray(hmc_results['samples']).std(0).tolist(),
            'mc_valid': ok, 'mc_mean': fits['values'].mean(0).tolist(),
            'mc_std': fits['values'].std(0).tolist(),
            'mc_errors': fits['errors'].mean(0).tolist(),
            'truth': [float(vega.params[n]) for n in fits['names']]}


if __name__ == '__main__':
    main()
