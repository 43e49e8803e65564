"""Generate the DESI Y1 (DR1) baseline BAO fit configs — data edition,
with the PyTorch port (vega_tpu_torch).

Counterpart of the reference's examples/DESI_data_setup (NERSC-path
config snapshots): the combined 4-correlation fit with the DESI
baseline model — Rogers2018 HCD with sampled L0, Arinyo small-scale
non-linearities, DESI instrumental systematics, QSO radiation effects,
Lorentzian velocity dispersion, and in-framework metal matrices
computed from the delta-attribute weights (new_metals; reference:
metals.py:502-654), plus a smoothed joint (global) covariance.

Point it at a picca production:

  python make_configs.py \
      --correlations-dir .../correlations/baseline/results \
      --weights-lya .../deltas_lya/Log/delta_attributes.fits.gz \
      --weights-lyb .../deltas_lyb/Log/delta_attributes.fits.gz \
      --qso-cat .../QSO_cat.fits \
      --global-cov .../full-covariance-smoothed.fits \
      --out-dir ./configs

then fit with:
  python -m vega_tpu_torch.scripts.run_vega configs/main-baseline_combined.ini

Counterpart of make_configs.py in this directory: it writes the same
files through vega_tpu_torch's BuildConfig.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse  # noqa: E402

from vega_tpu_torch.build_config import BuildConfig  # noqa: E402

METALS = ['SiII(1190)', 'SiII(1193)', 'SiIII(1207)', 'SiII(1260)',
          'CIV(eff)']

OPTIONS = {
    'scale_params': 'ap_at',
    'template': 'Planck18/DESI-2024_z_2.33.fits',
    'small_scale_nl': True,
    'bao_broadening': True,
    'hcd_model': 'Rogers2018',
    'velocity_dispersion': 'lorentz',
    'radiation_effects': True,
    'desi-instrumental-systematics': True,
    'metals': METALS,
    'new_metals': True,
    'rebin-metals': 3,
}

SAMPLED = ['ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_QSO',
           'sigma_velo_disp_lorentz_QSO', 'drp_QSO', 'qso_rad_strength',
           'bias_hcd', 'beta_hcd', 'L0_hcd',
           'bias_SiII(1190)', 'bias_SiII(1193)', 'bias_SiIII(1207)',
           'bias_SiII(1260)', 'bias_CIV(eff)', 'desi_inst_sys_amp']

PRIORS = {
    'drp_QSO': 'gaussian 0.0 0.1',
    'beta_hcd': 'gaussian 0.50 0.09',
    'L0_hcd': 'gaussian 5.0 2.0',
    'bias_CIV(eff)': 'gaussian -0.019 0.005',
    'sigma_velo_disp_lorentz_QSO': 'gaussian 5.21 0.85',
}


def main(extra_options=None, argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--correlations-dir', required=True)
    parser.add_argument('--weights-lya', required=True)
    parser.add_argument('--weights-lyb', required=True)
    parser.add_argument('--qso-cat', required=True)
    parser.add_argument('--global-cov', default=None)
    parser.add_argument('--out-dir', default='./configs')
    parser.add_argument('--zeff', type=float, default=2.33)
    args = parser.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cdir = Path(args.correlations_dir)

    def corr(name, subdir, w1, w2, is_cross):
        return {
            'corr_path': str(cdir / subdir / 'cf_exp.fits.gz'),
            'distortion-file': str(cdir / subdir / 'dmat.fits.gz'),
            'weights-tracer1': w1, 'weights-tracer2': w2,
            'r-min': 10., 'r-max': 180.,
            'rp-min': -200. if is_cross else 0.,
            'fast_metals': 'True',
        }

    correlations = {
        'lyaxlya': corr('lyaxlya', 'lyalya_lyalya',
                        args.weights_lya, args.weights_lya, False),
        'lyaxlyb': corr('lyaxlyb', 'lyalya_lyalyb',
                        args.weights_lya, args.weights_lyb, False),
        'lyaxqso': corr('lyaxqso', 'lyalya_qso',
                        args.qso_cat, args.weights_lya, True),
        'lybxqso': corr('lybxqso', 'lyalyb_qso',
                        args.qso_cat, args.weights_lyb, True),
    }

    options = dict(OPTIONS)
    options.update(extra_options or {})
    builder = BuildConfig(options=options, overwrite=True)
    fit_info = {
        'fitter': True, 'zeff': args.zeff,
        'sample_params': SAMPLED,
        'priors': {k: v for k, v in PRIORS.items() if k in SAMPLED},
    }
    if args.global_cov:
        fit_info['global_cov_file'] = args.global_cov

    main_path = builder.build(correlations,
                              'lyaxlya_lyaxlyb_lyaxqso_lybxqso',
                              fit_info, out,
                              parameters={'desi_inst_sys_amp': 0.00032,
                                          'qso_rad_strength': 0.74},
                              name_extension='baseline_combined')
    print(f'wrote {main_path}')
    return main_path


if __name__ == '__main__':
    main()
