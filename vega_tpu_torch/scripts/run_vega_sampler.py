#!/usr/bin/env python
"""Run the sampler a configuration names.

    python -m vega_tpu_torch.scripts.run_vega_sampler main.ini [--device cpu]

Counterpart of vega_tpu/scripts/run_vega_sampler.py: one process drives
batched likelihood evaluations on one device (the card unless --device
says otherwise), through the sampler [control] names.
"""

import argparse
import sys


def run(argv=None):
    """Build the interface and the sampler the config names, and run it:
    (interface, sampler, the sampler's results)."""
    pars = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Run the sampler with device-batched likelihoods.')
    pars.add_argument('config', type=str, help='Config file')
    pars.add_argument('--device', type=str, default='cuda',
                      help="Device the likelihood runs on: 'cuda', "
                           "'cuda:N' or 'cpu'")
    args = pars.parse_args(argv)

    from vega_tpu_torch.parallel import BatchedLikelihood
    from vega_tpu_torch.vega_interface import VegaInterface

    print('Initializing vega_tpu_torch')
    vega = VegaInterface(args.config, device=args.device)
    sampling_params = vega.sample_params['limits']

    run_montecarlo = vega.main_config['control'].getboolean(
        'run_montecarlo', False)
    if run_montecarlo and vega.mc_config is not None:
        _ = vega.initialize_monte_carlo()
        sampling_params = vega.mc_config['sample']['limits']
    elif run_montecarlo:
        raise ValueError('You asked to run over a Monte Carlo simulation, '
                         'but no "[monte carlo]" section provided.')

    if not vega.run_sampler:
        raise ValueError('Sampler not requested. Add "run_sampler = True" '
                         'to the "[control]" section.')

    batched = BatchedLikelihood(vega)

    if vega.sampler == 'Polychord':
        from vega_tpu_torch.samplers.polychord import Polychord

        print('Running native nested sampler (Polychord settings)')
        # the native sampler accepts the BatchedLikelihood itself and
        # fuses the per-iteration evolution on the device (nested.py)
        sampler = Polychord(vega.main_config['Polychord'], sampling_params,
                            batched, vega.corr_num_marg_modes)

    elif vega.sampler == 'PocoMC':
        from vega_tpu_torch.samplers.pocomc import PocoMC

        print('Running native SMC sampler (PocoMC settings)')
        sampler = PocoMC(vega.main_config['PocoMC'], sampling_params,
                         batched.log_lik)

    elif vega.sampler == 'NestedJax':
        from vega_tpu_torch.samplers.nested import NestedSampler

        print('Running native nested sampler')
        sampler = NestedSampler(vega.main_config['NestedJax'],
                                sampling_params, batched,
                                vega.corr_num_marg_modes)

    elif vega.sampler == 'HMC':
        from vega_tpu_torch.samplers.hmc import HMC

        print('Running native exact-gradient HMC sampler')
        sampler = HMC(vega.main_config['HMC'], sampling_params, batched)
    else:
        raise ValueError(f'Unknown sampler {vega.sampler}')

    results = sampler.run()
    print('Finished running sampler')
    return vega, sampler, results


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
