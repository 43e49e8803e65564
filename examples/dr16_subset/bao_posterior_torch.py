#!/usr/bin/env python
"""End-to-end BAO posterior + evidence on one GPU, with vega_tpu_torch.

The PyTorch / CUDA counterpart of examples/dr16_subset/bao_posterior.py:
a full auto+cross Lyman-alpha likelihood with (alpha_par, alpha_perp,
bias, beta) sampled, driven by the native batched nested sampler
(vega_tpu_torch/samplers/nested.py: one CUDA graph replay per iteration)
or by the exact-gradient HMC, through device-batched likelihood
evaluations on the grid collapse.

Two datasets:

- ``synthetic`` (default): a DR16-shaped auto+cross injection at
  ap = at = 1 with realistic per-bin S/N (vega_tpu_torch.testing), so the
  posterior constrains the BAO scale: an injection-recovery run (mean
  within ~1 sigma of the truth, sigma_ap ~ 1%).
- ``dr16``: the reference checkout's DR16-subset parity fixture
  (tests/full_configs under $VEGA_REFERENCE; without it, or without the
  checkout there, the run fails with a KeyError). Its shipped covariance
  is the identity, so the posterior is prior-dominated: a timing run on
  real data shapes, not a constraint.

The precision follows VEGA_TPU_X64 as VegaInterface reads it: unset, f64;
VEGA_TPU_X64=0, vega_tpu's f32 throughput mode.

Usage:

    python examples/dr16_subset/bao_posterior_torch.py \
        [--dataset synthetic|dr16] [--sampler ns|hmc] [--num-live 512] \
        [--precision 1e-3] [--workdir DIR] [--device cpu]

Without --workdir the files go to a new directory under $TMPDIR.
"""

import argparse
import configparser
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _sampler_sections(config, workdir, args):
    config['control']['run_sampler'] = 'True'
    config['control']['sampler'] = ('HMC' if args.sampler == 'hmc'
                                    else 'Polychord')
    config['Polychord'] = {
        'path': str(workdir),
        'name': f'bao_posterior_{args.dataset}',
        'num_live': str(args.num_live),
        'precision': str(args.precision),
        'resume': 'False',   # never pick up a stale checkpoint
        'seed': '0',
    }
    if args.batch_size:
        config['Polychord']['batch_size'] = str(args.batch_size)
    config['HMC'] = {
        'path': str(workdir),
        'name': f'bao_posterior_hmc_{args.dataset}',
        'num_chains': '32',
        'num_samples': '600',
        'num_warmup': '400',
        'seed': '0',
    }


def _read_ini(path):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(path)
    return config


def build_synthetic_config(workdir, args):
    """DR16-shaped auto+cross injection at ap = at = 1 with realistic
    per-bin uncertainties; the posterior must recover the injection."""
    from vega_tpu_torch import testing
    main_path = testing.make_synthetic_dataset(
        str(workdir), cross=True, device=args.device,
        sample={'ap': '0.9 1.1', 'at': '0.9 1.1',
                'bias_LYA': 'True', 'beta_LYA': 'True'})
    config = _read_ini(main_path)
    _sampler_sections(config, workdir, args)
    with open(main_path, 'w') as f:
        config.write(f)
    return main_path


def build_dr16_config(workdir, args, reference):
    """The DR16-subset parity fixture of the `reference` checkout with
    the BAO scale parameters sampled (identity covariance: a timing run,
    not a constraint)."""
    config = _read_ini(reference / 'tests' / 'full_configs' / 'main.ini')
    config['data sets']['ini files'] = ' '.join(
        str(reference / 'tests' / 'full_configs' / f'{c}.ini')
        for c in ('lyalya_lyalya', 'lyalya_lyalyb',
                  'lyalya_qso', 'lyalyb_qso'))
    config['sample']['ap'] = '0.8 1.2'
    config['sample']['at'] = '0.8 1.2'
    _sampler_sections(config, workdir, args)
    main_path = workdir / 'main.ini'
    with open(main_path, 'w') as f:
        config.write(f)
    return main_path


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--dataset', choices=('synthetic', 'dr16'),
                      default='synthetic')
    pars.add_argument('--sampler', choices=('ns', 'hmc'), default='ns',
                      help='ns: native nested sampling (posterior + '
                           'evidence); hmc: native exact-gradient HMC '
                           '(posterior only)')
    pars.add_argument('--num-live', type=int, default=512)
    pars.add_argument('--precision', type=float, default=1e-3)
    pars.add_argument('--batch-size', type=int, default=None)
    pars.add_argument('--workdir', type=str, default=None,
                      help='Directory of the files written (default: a '
                           'new one under $TMPDIR)')
    pars.add_argument('--device', type=str, default='cuda',
                      help="Device the likelihood runs on: 'cuda', "
                           "'cuda:N' or 'cpu'")
    args = pars.parse_args(argv)

    if args.workdir is None:
        workdir = Path(tempfile.mkdtemp(prefix='bao_demo_torch_'))
    else:
        workdir = Path(args.workdir)
        workdir.mkdir(parents=True, exist_ok=True)

    import numpy as np
    import torch

    from vega_tpu_torch.parallel import BatchedLikelihood
    from vega_tpu_torch.samplers.nested import NestedSampler
    from vega_tpu_torch.vega_interface import VegaInterface

    def synchronize():
        if torch.device(args.device).type == 'cuda':
            torch.cuda.synchronize(args.device)

    t0 = time.time()
    cwd = os.getcwd()
    if args.dataset == 'dr16':
        reference = Path(os.environ['VEGA_REFERENCE'])
        main_path = build_dr16_config(workdir, args, reference)
        os.chdir(reference / 'tests')
    else:
        main_path = build_synthetic_config(workdir, args)
    try:
        vega = VegaInterface(str(main_path), device=args.device)
        t_init = time.time() - t0

        batched = BatchedLikelihood(vega)
        # one throwaway batch: the grid payload's sweep and the first
        # call's set-up, out of the sampling time
        t1 = time.time()
        batched.log_lik({name: np.full(8, vega.sample_params['values'][name])
                         for name in vega.sample_params['limits']})
        synchronize()
        t_setup = time.time() - t1

        t2 = time.time()
        if args.sampler == 'hmc':
            from vega_tpu_torch.samplers.hmc import HMC
            sampler = HMC(vega.main_config['HMC'],
                          vega.sample_params['limits'], batched)
        else:
            # the BatchedLikelihood itself, so that the sampler runs each
            # iteration's slice evolution as one device dispatch
            sampler = NestedSampler(vega.main_config['Polychord'],
                                    vega.sample_params['limits'],
                                    batched, vega.corr_num_marg_modes)
        results = sampler.run()
        synchronize()
        t_sample = time.time() - t2
    finally:
        os.chdir(cwd)

    names = list(vega.sample_params['limits'].keys())
    w = results.get('weights')
    if w is None:
        w = np.ones(len(results['samples']))
    mean = np.average(results['samples'], weights=w, axis=0)
    std = np.sqrt(np.average((results['samples'] - mean) ** 2,
                             weights=w, axis=0))
    precision = 'f32' if vega.dtype == torch.float32 else 'f64'
    print(f'\n=== BAO posterior ({args.dataset}, {args.sampler}, '
          f'{len(names)} sampled params, {precision}, {vega.device}) ===')
    if args.sampler == 'hmc':
        ess = float(np.min(results['ess']))
        print(f'init {t_init:.1f} s | set-up {t_setup:.1f} s | '
              f'warmup+sampling {t_sample:.1f} s '
              f'(min ESS {ess:.0f} -> {ess / t_sample:.0f} ESS/s) | '
              f'total {time.time() - t0:.1f} s')
    else:
        n_evals = getattr(sampler, '_n_evals', 0)
        print(f'init {t_init:.1f} s | set-up {t_setup:.1f} s | '
              f'sampling {t_sample:.1f} s ({n_evals} likelihood evals) | '
              f'total {time.time() - t0:.1f} s')
        print(f'logZ = {results["logz"]:.4f} '
              f'+/- {results["logz_err"]:.4f}')
    for i, name in enumerate(names):
        print(f'{name:>16s} = {mean[i]:+.5f} +/- {std[i]:.5f}')
    return results


if __name__ == '__main__':
    main()
