"""Tutorial 7 — Programmatic config creation with BuildConfig, with the
PyTorch port (vega_tpu_torch) on the GPU.

Counterpart of examples/tutorials/07_config_creation.py: BuildConfig is
"the preferred way of interacting" with the framework: it turns a
dictionary of model options + data paths into the full main.ini /
per-correlation ini set, resolving parameter defaults and computing the
effective redshift from the data.

Run:  python 07_config_creation.py [--device cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse   # noqa: E402
import tempfile   # noqa: E402

import numpy as np   # noqa: E402

from vega_tpu_torch.build_config import BuildConfig         # noqa: E402
from vega_tpu_torch.testing import _write_correlation_data  # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface     # noqa: E402


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    args = pars.parse_args(argv)

    workdir = Path(tempfile.mkdtemp(prefix='vega_tutorial_'))

    # Some measured correlation files (synthetic stand-ins here; point
    # corr_path at picca exports for real data)
    rng = np.random.default_rng(0)
    auto_file = workdir / 'cf_exp.fits'
    _write_correlation_data(auto_file, False, 2.33, rng, nt=20)

    options = {
        'scale_params': 'ap_at',
        'template': 'PlanckDR16/PlanckDR16.fits',  # shipped fiducial
        'small_scale_nl': True,       # Arinyo
        'bao_broadening': True,       # sigmaNL
        'hcd_model': 'Rogers2018',
        'metals': None,               # add ['SiIII(1207)', ...] with real data
        'test': True,
    }

    builder = BuildConfig(options=options, overwrite=True)
    fit_info = {
        'fitter': True,
        'sample_params': ['ap', 'at', 'bias_LYA', 'beta_LYA'],
        'zeff': 2.33,
    }
    correlations = {'lyaxlya': {'corr_path': str(auto_file),
                                'r-min': 20., 'r-max': 180.}}

    main_path = builder.build(correlations, 'lyaxlya', fit_info, workdir,
                              parameters={'bias_LYA': -0.117})
    print(f'generated {main_path}')
    print((workdir / 'lyaxlya.ini').read_text()[:400], '...\n')

    # The generated configs drive the standard interface directly
    vega = VegaInterface(main_path, device=args.device)
    chi2 = vega.chi2({'bias_LYA': -0.117, 'beta_LYA': 1.67})
    print(f'chi2 on the generated setup: {chi2:.2f}')
    return {'chi2': float(chi2)}


if __name__ == '__main__':
    main()
