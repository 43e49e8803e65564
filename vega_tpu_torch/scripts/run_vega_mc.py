#!/usr/bin/env python
"""Draw Monte-Carlo mocks and fit them on one GPU.

    python -m vega_tpu_torch.scripts.run_vega_mc main.ini [--sequential]
        [--device cpu]

Counterpart of vega_tpu/scripts/run_vega_mc.py: the num_mc_mocks
realizations are drawn on the device from a torch generator seeded with
mc_seed and fit as rows of one batched Newton
(parallel.MonteCarloEngine); --sequential keeps the reference's loop
(Analysis.run_monte_carlo, numpy global RNG). The results go to
`[output] mc_output` (default <filename's directory>/monte_carlo) as
monte_carlo.fits (Output.write_monte_carlo): Bestfit, FitInfo, Mocks.
Sharding over several cards is not ported: --n-devices takes 1 only.
"""

import argparse
import sys

import numpy as np


def store_fits(analysis, results, mocks):
    """Put MonteCarloEngine's results (None: no fits) and the mocks into
    the Analysis containers Output.write_monte_carlo reads
    (vega_tpu/scripts/run_vega_mc.py:64-88)."""
    analysis.mc_mocks = {name: list(np.asarray(m)) for name, m in mocks.items()}
    analysis.has_monte_carlo = True
    if results is None:
        analysis.mc_bestfits, analysis.mc_covariances = {}, []
        analysis.mc_chisq, analysis.mc_valid_minima = [], []
        analysis.mc_valid_hesse, analysis.mc_failed_mask = [], []
        return
    analysis.mc_bestfits = {
        name: np.stack([results['values'][:, i], results['errors'][:, i]],
                       axis=1)
        for i, name in enumerate(results['names'])}
    analysis.mc_covariances = list(results['covariances'])
    analysis.mc_chisq = list(results['chisq'])
    analysis.mc_valid_minima = list(results['valid'])
    analysis.mc_valid_hesse = list(np.isfinite(
        results['errors']).all(axis=1))
    analysis.mc_failed_mask = list(~np.asarray(results['valid']))


def check_devices(n_devices):
    from vega_tpu_torch.utils import not_ported
    if n_devices not in (None, 1):
        raise not_ported(f'--n-devices {n_devices} (mock fits sharded over '
                         'several cards)', 8)


def main(argv=None):
    pars = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Run Monte-Carlo mock fits in one batch on one device.')
    pars.add_argument('config', type=str, help='Config file')
    pars.add_argument('--sequential', action='store_true',
                      help='Reference-style sequential mock loop')
    pars.add_argument('--n-devices', type=int, default=None,
                      help='Cards to shard the mocks over (1 only)')
    pars.add_argument('--device', type=str, default='cuda',
                      help="Device the fits run on: 'cuda', 'cuda:N' or "
                           "'cpu'")
    args = pars.parse_args(argv)
    check_devices(args.n_devices)

    from vega_tpu_torch.parallel import MonteCarloEngine
    from vega_tpu_torch.vega_interface import VegaInterface

    print('Initializing vega_tpu_torch')
    vega = VegaInterface(args.config, device=args.device)
    control = vega.main_config['control']

    if not control.getboolean('run_montecarlo', False) \
            or vega.mc_config is None:
        raise ValueError('Monte Carlo not requested. Add "run_montecarlo = '
                         'True" to the "[control]" section.')

    fiducial_model = vega.get_fiducial_for_monte_carlo()
    vega.monte_carlo = True

    forecast = control.getboolean('forecast', False)
    if forecast:
        raise ValueError('You asked to run a forecast. Use run_vega instead.')

    seed = control.getint('mc_seed', 0)
    num_mc_mocks = control.getint('num_mc_mocks', 1)
    run_mc_fits = control.getboolean('run_mc_fits', True)

    if args.sequential:
        vega.analysis.run_monte_carlo(
            fiducial_model, num_mocks=num_mc_mocks, seed=seed,
            forecast=forecast, run_mc_fits=run_mc_fits)
        vega.output.write_monte_carlo()
        return 0

    engine = MonteCarloEngine(vega)
    mocks = engine.generate_mocks(fiducial_model, num_mc_mocks, seed=seed)
    mocks = {name: m.cpu().numpy() for name, m in mocks.items()}
    store_fits(vega.analysis,
               engine.fit_mocks(mocks) if run_mc_fits else None, mocks)
    vega.output.write_monte_carlo()
    return 0


if __name__ == '__main__':
    sys.exit(main())
