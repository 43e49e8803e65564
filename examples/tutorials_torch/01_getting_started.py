"""Tutorial 1 — Getting started: a complete fit in ~20 lines, with the
PyTorch port (vega_tpu_torch) on the GPU.

Counterpart of examples/tutorials/01_getting_started.py: build an
interface from a main.ini, look at the model, evaluate the likelihood,
minimize, and read the results. The dataset is synthetic (generated from
the framework's own model, so the fit has a known truth); substitute
your own main.ini for real analyses.

Run:  python 01_getting_started.py [--device cpu] [--size tiny]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse   # noqa: E402
import tempfile   # noqa: E402

from vega_tpu_torch.testing import make_synthetic_dataset   # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface     # noqa: E402


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    pars.add_argument('--size', default='full', choices=('full', 'tiny'),
                      help='size of the synthetic dataset')
    args = pars.parse_args(argv)

    # --- 1. A fit setup is one main.ini + one ini per correlation -----
    workdir = tempfile.mkdtemp(prefix='vega_tutorial_')
    main_path = make_synthetic_dataset(workdir, cross=True,   # auto + cross
                                       size=args.size, device=args.device)
    print(f'configs + data in {workdir}')

    # --- 2. The interface parses configs, loads data, builds models ---
    vega = VegaInterface(main_path, device=args.device)

    # --- 3. Model and likelihood at any parameter point ---------------
    # Parameters not passed keep their [parameters] values from the
    # config.
    model_cf = vega.compute_model({'bias_LYA': -0.12}, run_init=False)
    for name, cf in model_cf.items():
        print(f'model {name}: {cf.shape} bins, mean {cf.mean():.3e}')

    chi2 = vega.chi2({'bias_LYA': -0.12, 'beta_LYA': 1.6})
    loglik = vega.log_lik({'bias_LYA': -0.12, 'beta_LYA': 1.6})
    print(f'chi2 = {chi2:.3f}   log L = {loglik:.3f}')

    # --- 4. Fit the sampled parameters ([sample] in main.ini) ---------
    vega.minimize()

    # --- 5. Results: Minuit-compatible surface ------------------------
    best = vega.bestfit
    print('\nbest fit:')
    for name, value in best.values.items():
        print(f'  {name} = {value:+.5f} +- {best.errors[name]:.5f}')
    print(f'chi2 at minimum: {best.fmin.fval:.4f} '
          f'(valid={best.fmin.is_valid})')
    cov = best.covariance[('bias_LYA', 'beta_LYA')]
    print(f'covariance(bias, beta) = {cov:.3e}')
    return {'chi2': float(chi2), 'log_lik': float(loglik),
            'model_mean': {n: float(cf.mean()) for n, cf in model_cf.items()},
            'values': dict(best.values), 'errors': dict(best.errors),
            'fval': float(best.fmin.fval), 'valid': bool(best.fmin.is_valid),
            'covariance': float(cov)}


if __name__ == '__main__':
    main()
