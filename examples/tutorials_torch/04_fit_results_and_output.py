"""Tutorial 4 — Output files and FitResults, with the PyTorch port
(vega_tpu_torch) on the GPU.

Counterpart of examples/tutorials/04_fit_results_and_output.py: run a
fit through the standard driver (which writes the FITS results file),
read it back with FitResults, and build a Gaussian-approximation chain.

Run:  python 04_fit_results_and_output.py [--device cpu] [--size tiny]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse   # noqa: E402
import tempfile   # noqa: E402

from vega_tpu_torch.postprocess.fit_results import FitResults  # noqa: E402
from vega_tpu_torch.scripts.run_vega import run_vega          # noqa: E402
from vega_tpu_torch.testing import make_synthetic_dataset     # noqa: E402


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    pars.add_argument('--size', default='full', choices=('full', 'tiny'),
                      help='size of the synthetic dataset')
    args = pars.parse_args(argv)

    workdir = Path(tempfile.mkdtemp(prefix='vega_tutorial_'))
    main_path = make_synthetic_dataset(workdir, cross=False, size=args.size,
                                       device=args.device)

    # The standard driver: minimize -> write FITS results (+ scans/plots
    # when configured)
    run_vega(main_path, args.device)

    out_file = Path(str(workdir / 'output') + '.fits')
    print(f'\nresults file: {out_file}')

    # --- Read everything back ------------------------------------------
    results = FitResults(out_file)
    print('bestfit parameters:', results.params)
    print(f'chi2 = {results.chisq:.4f}, PTE = {results.p_value:.3f}')

    corr = results.correlations['lyaxlya']
    print(f'stored model: {corr.model.shape}, data: {corr.data.shape}')

    # --- Gaussian-approximation chain (getdist when installed, internal
    # fallback otherwise) -----------------------------------------------
    chain = results.chain
    moments = {}
    for name in results.names:
        moments[str(name)] = (float(chain.mean(name)), float(chain.std(name)))
        print(f'  {name}: mean {chain.mean(name):+.5f}, '
              f'std {chain.std(name):.5f}')
    return {'params': {str(k): float(v) for k, v in results.params.items()},
            'chisq': float(results.chisq), 'p_value': float(results.p_value),
            'model_shape': list(corr.model.shape), 'chain': moments}


if __name__ == '__main__':
    main()
