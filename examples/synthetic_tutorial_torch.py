#!/usr/bin/env python
"""End-to-end tutorial on a self-contained synthetic dataset, with the
PyTorch port (vega_tpu_torch) on the GPU.

Counterpart of synthetic_tutorial.py. Covers the core workflow without
any external data:
  1. generate a synthetic auto+cross dataset (EH98 fiducial template)
  2. evaluate the likelihood
  3. fit with exact gradients
  4. run a batched likelihood over a parameter grid
  5. generate and fit Monte-Carlo mocks in one device-sharded batch
  6. write the results FITS and diagnostic plots (the plots where
     matplotlib is installed)

Run:  python examples/synthetic_tutorial_torch.py [workdir] [--device cpu]
"""

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('workdir', nargs='?', default=None)
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    args = pars.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix='vega_tpu_tutorial_')

    from vega_tpu_torch.testing import make_synthetic_dataset
    from vega_tpu_torch.vega_interface import VegaInterface

    print(f'=== Generating synthetic dataset in {workdir}')
    main_path = make_synthetic_dataset(workdir, cross=True, noise=1.0,
                                       size='tiny', seed=12,
                                       device=args.device)

    print('=== Initializing the likelihood')
    vega = VegaInterface(main_path, device=args.device)

    log_lik = vega.log_lik({'bias_LYA': -0.117, 'beta_LYA': 1.67})
    print('log_lik at the truth:', log_lik)

    print('=== Fitting (L-BFGS-B with exact autograd gradients)')
    vega.minimize()
    print('bestfit:', vega.bestfit.values)
    print('errors :', vega.bestfit.errors)

    print('=== Batched likelihood over a parameter grid')
    from vega_tpu_torch.parallel import BatchedLikelihood
    bias_grid = np.linspace(-0.14, -0.10, 16)
    bl = BatchedLikelihood(vega)
    chi2_grid = bl.chi2({'bias_LYA': bias_grid,
                         'beta_LYA': np.full(16, 1.67)}).cpu().numpy()
    print('chi2 minimum on the grid at bias =',
          bias_grid[np.argmin(chi2_grid)])

    print('=== Batched Monte-Carlo mocks')
    from vega_tpu_torch.parallel import MonteCarloEngine
    engine = MonteCarloEngine(vega)
    fiducial = vega.compute_model(vega.bestfit.values, run_init=False)
    mocks = engine.generate_mocks(fiducial, num_mocks=8, seed=0)
    results = engine.fit_mocks(mocks, sample_params={
        'limits': {'bias_LYA': (-1.0, 0.0), 'beta_LYA': (0.5, 3.0)},
        'values': dict(vega.bestfit.values),
        'errors': {'bias_LYA': 0.01, 'beta_LYA': 0.1},
        'fix': {'bias_LYA': False, 'beta_LYA': False},
    }, max_iterations=10)
    print('mock bias_LYA scatter:', results['values'][:, 0].std())

    print('=== Writing outputs')
    vega.output.write_results(vega.bestfit_model, vega.params,
                              vega.minimizer, vega.bestfit_corr_stats)
    out = {'log_lik': float(log_lik), 'values': dict(vega.bestfit.values),
           'errors': dict(vega.bestfit.errors),
           'chi2_grid': chi2_grid.tolist(),
           'mock_scatter': float(results['values'][:, 0].std()),
           'mock_errors': results['errors'].mean(0).tolist()}
    if importlib.util.find_spec('matplotlib') is None:
        print('wrote', vega.output.outfile + '.fits',
              '(matplotlib is not installed: the plots are skipped)')
        return out
    import matplotlib
    matplotlib.use('Agg')
    name = next(iter(vega.corr_items))
    vega.plots.plot_4wedges(models=[vega.bestfit_model[name]],
                            corr_name=name, mu_bin_labels=True,
                            model_colors=['r'])
    fig_path = f'{vega.output.outfile}_{name}_wedges.png'
    vega.plots.fig.savefig(fig_path, bbox_inches='tight')
    print('wrote', vega.output.outfile + '.fits', 'and', fig_path)
    return out


if __name__ == '__main__':
    main()
