"""Generate a LyaCoLoRe raw-mock fit config with the PyTorch port
(vega_tpu_torch).

Counterpart of the reference's examples/lyacolore_mocks (a main.ini +
lyalya_lyalya.ini snapshot): the Lya auto-correlation of raw
(continuum-free) mocks, whose model needs gaussian full-shape smoothing
instead of the data's small-scale non-linear terms, and the DR9 mock
fiducial.

  python make_configs.py --cf /path/to/cf_z_0_10-exp.fits \
      [--dmat /path/to/dmat_z_0_10.fits] --out-dir ./configs

then fit with:  python -m vega_tpu_torch.scripts.run_vega configs/main.ini

Counterpart of make_configs.py in this directory: it writes the same
files through vega_tpu_torch's BuildConfig.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse  # noqa: E402

from vega_tpu_torch.build_config import BuildConfig  # noqa: E402

OPTIONS = {
    'scale_params': 'ap_at',
    'template': 'DR9LyaMocks/DR9LyaMocks.fits',   # mock cosmology
    'small_scale_nl': False,
    'bao_broadening': False,
    'fullshape_smoothing': 'gauss',
    'metals': None,
}


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--cf', required=True)
    parser.add_argument('--dmat', default=None)
    parser.add_argument('--out-dir', default='./configs')
    parser.add_argument('--zeff', type=float, default=None,
                        help='skip the inverse-variance zeff computation '
                             '(which reads the correlation file)')
    args = parser.parse_args()

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    corr = {'corr_path': args.cf, 'r-min': 10., 'r-max': 180.,
            'rp-min': 0.}
    if args.dmat:
        corr['distortion-file'] = args.dmat

    builder = BuildConfig(options=dict(OPTIONS), overwrite=True)
    fit_info = {
        'fitter': True,
        'sample_params': ['ap', 'at', 'bias_LYA', 'beta_LYA',
                          'par_sigma_smooth', 'per_sigma_smooth'],
    }
    if args.zeff is not None:
        fit_info['zeff'] = args.zeff
    main_path = builder.build({'lyaxlya': corr}, 'lyaxlya', fit_info, out,
                              parameters={'par_sigma_smooth': 2.4,
                                          'per_sigma_smooth': 2.4})
    print(f'wrote {main_path}')


if __name__ == '__main__':
    main()
