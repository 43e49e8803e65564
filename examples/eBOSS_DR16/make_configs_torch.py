"""Generate the eBOSS DR16 Lya BAO analysis configs (auto / cross /
combined) with the PyTorch port (vega_tpu_torch), reproducing the reference's examples/eBOSS_DR16 setup
(reference: examples/eBOSS_DR16/README.rst:1 — Table 6 of du Mas des
Bourboux et al. 2020, arXiv:2007.08995) through BuildConfig, the
framework's preferred config front end.

The measured correlations + metal matrices are the public SDSS DR16
data vectors:
  https://svn.sdss.org/public/data/eboss/DR16cosmo/tags/v1_0_1/
      dataveccov/lya_forest/
Download them and run:

  python make_configs.py --data-dir /path/to/lya_forest --out-dir ./configs

This writes main_auto.ini, main_cross.ini and main_combined.ini plus the
four per-correlation configs. Fit any of them with:

  python -m vega_tpu_torch.scripts.run_vega configs/main_combined.ini

Counterpart of make_configs.py in this directory: it writes the same
files through vega_tpu_torch's BuildConfig. For a self-contained
demonstration (synthetic data, no download) see run_synthetic_torch.py
in this directory.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse  # noqa: E402
import json      # noqa: E402

from vega_tpu_torch.build_config import BuildConfig  # noqa: E402

MANIFEST = (Path(__file__).resolve().parents[2] / 'vega_tpu' / 'models'
            / 'dr16_manifest.json')


def load_manifest():
    """The shipped SVN manifest, read by path (the file
    vega_tpu/scripts/verify_dr16.py:load_manifest reads)."""
    with open(MANIFEST) as fh:
        return json.load(fh)


# Data/metal file names come from the shipped SVN manifest
# (vega_tpu/models/dr16_manifest.json — the names the reference's own
# examples/eBOSS_DR16/*.ini quote for the public download), so the
# generated configs always match what verify_dr16 validates.
DR16_FILES = {
    (info['corr'], info['kind']): fname
    for fname, info in load_manifest()['files'].items()
}

# DR16 model options (reference: examples/eBOSS_DR16/lyalyaxlyalya.ini)
DR16_OPTIONS = {
    'scale_params': 'ap_at',
    'template': 'PlanckDR16/PlanckDR16_z_2.334.fits',
    'small_scale_nl': True,            # dnl_arinyo on the Lya autos
    'bao_broadening': True,            # sigmaNL_par / sigmaNL_per
    'hcd_model': 'Rogers2018',
    'velocity_dispersion': 'lorentz',  # QSO cross
    'metals': ['CIV(eff)', 'SiII(1260)', 'SiIII(1207)', 'SiII(1193)',
               'SiII(1190)'],
    'use_metal_bias_eta': True,
}

# The DR16 compatibility switches: the published analysis used the
# original hand-rolled FFTLog conventions and the old growth function
DR16_EXTRA_MODEL = {'old_fftlog': 'True', 'old_growth_func': 'True',
                    'ell-max': '6'}

SKY_BB = {'bb1': 'add pre rp,rt 0:0:1 0:0:1 broadband_sky'}

SAMPLED_BAO = {
    'ap': 'True', 'at': 'True',
    'bias_eta_LYA': 'True', 'beta_LYA': 'True',
}
# HCD parameters are sampled in the auto and combined fits only — the
# reference's main_cross.ini does not sample them (the cross has no
# HCD-damped auto spectra driving them).
SAMPLED_HCD = {'bias_hcd': 'True', 'beta_hcd': 'True'}
SAMPLED_METALS = {
    f'bias_eta_{m}': '-0.02 0. -0.003 0.01'
    for m in ['SiII(1260)', 'SiIII(1207)', 'SiII(1193)', 'SiII(1190)',
              'CIV(eff)']
}
# The cross-only fit samples neither beta_QSO nor the CIV bias
# (reference: examples/eBOSS_DR16/main_cross.ini [sample]).
SAMPLED_METALS_CROSS = {k: v for k, v in SAMPLED_METALS.items()
                        if 'CIV' not in k}
SAMPLED_CROSS = {
    'drp_QSO': 'True',
    'sigma_velo_disp_lorentz_QSO': 'True',
}
SAMPLED_CROSS_COMBINED = dict(SAMPLED_CROSS, beta_QSO='True')
SAMPLED_SKY = {
    'BB-{name}-0-broadband_sky-scale-sky': '0 0.5 0.01 0.1',
    'BB-{name}-0-broadband_sky-sigma-sky': '10 60 31. 0.1',
}

PRIORS = {
    'beta_hcd': 'gaussian 0.5 0.09',
    'bias_eta_CIV(eff)': 'gaussian -0.005 0.0026',
}

PARAMETERS = {
    'ap': 1.0, 'at': 1.0, 'bao_amp': 1.,
    'bias_eta_LYA': -0.201, 'beta_LYA': 1.669, 'alpha_LYA': 2.9,
    'bias_hcd': -0.0523, 'beta_hcd': 0.646, 'L0_hcd': 10.,
    'bias_eta_QSO': 1., 'beta_QSO': 0.26, 'alpha_QSO': 1.44,
    'drp_QSO': 0.0, 'sigma_velo_disp_lorentz_QSO': 6.86,
    'croom_par0': 0.53, 'croom_par1': 0.289,
    'bias_eta_SiII(1260)': -0.0027, 'beta_SiII(1260)': 0.5,
    'alpha_SiII(1260)': 1.,
    'bias_eta_SiIII(1207)': -0.0045, 'beta_SiIII(1207)': 0.5,
    'alpha_SiIII(1207)': 1.,
    'bias_eta_SiII(1193)': -0.0020, 'beta_SiII(1193)': 0.5,
    'alpha_SiII(1193)': 1.,
    'bias_eta_SiII(1190)': -0.0029, 'beta_SiII(1190)': 0.5,
    'alpha_SiII(1190)': 1.,
    'bias_eta_CIV(eff)': -0.0052, 'beta_CIV(eff)': 0.27,
    'alpha_CIV(eff)': 1.,
    'desi_inst_sys_amp': 0.0003189935987295203,
    'sigmaNL_per': 3.24, 'sigmaNL_par': 6.36984, 'growth_rate': 0.970386,
    'par_sigma_smooth': 2.4, 'per_sigma_smooth': 2.4,
    'par binsize lyaxlya': 4., 'per binsize lyaxlya': 4.,
    'par binsize lyaxlyb': 4., 'per binsize lyaxlyb': 4.,
    'par binsize lyaxqso': 4., 'per binsize lyaxqso': 4.,
    'par binsize lybxqso': 4., 'per binsize lybxqso': 4.,
}


def corr_info(data_dir, name, data_file, metal_file, is_cross):
    info = {
        'corr_path': str(Path(data_dir) / data_file),
        'metal_path': str(Path(data_dir) / metal_file),
        'r-min': 10., 'r-max': 180.,
        'rp-min': -200. if is_cross else 0.,
        'binsize': 4,
        'extra-model': dict(DR16_EXTRA_MODEL),
        'fast_metals': 'True',
    }
    if not is_cross:
        info['broadband'] = dict(SKY_BB)
    return info


def sky_params(names):
    out = {}
    for name in names:
        for key, val in SAMPLED_SKY.items():
            out[key.format(name=name)] = val
            pname = key.format(name=name)
            PARAMETERS.setdefault(pname, 0.01 if 'scale' in pname else 31.)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--data-dir', required=True,
                        help='directory with the SDSS DR16 lya_forest '
                             'correlation + metal files')
    parser.add_argument('--out-dir', default='./configs')
    args = parser.parse_args()

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    correlations = {
        name: corr_info(args.data_dir, name,
                        DR16_FILES[(name, 'correlation')],
                        DR16_FILES[(name, 'metal')],
                        is_cross=name.endswith('xqso'))
        for name in ('lyaxlya', 'lyaxlyb', 'lyaxqso', 'lybxqso')
    }

    fits = {
        'auto': ('lyaxlya_lyaxlyb',
                 {**SAMPLED_BAO, **SAMPLED_HCD, **SAMPLED_METALS,
                  **sky_params(['lyaxlya', 'lyaxlyb'])}),
        'cross': ('lyaxqso_lybxqso',
                  {**SAMPLED_BAO, **SAMPLED_METALS_CROSS,
                   **SAMPLED_CROSS}),
        'combined': ('lyaxlya_lyaxlyb_lyaxqso_lybxqso',
                     {**SAMPLED_BAO, **SAMPLED_HCD, **SAMPLED_METALS,
                      **SAMPLED_CROSS_COMBINED,
                      **sky_params(['lyaxlya', 'lyaxlyb'])}),
    }

    for label, (fit_type, sample) in fits.items():
        builder = BuildConfig(options=dict(DR16_OPTIONS), overwrite=True)
        fit_info = {
            'fitter': True, 'run_sampler': False,
            'zeff': 2.334,
            'sample_params': sample,
            'priors': {k: v for k, v in PRIORS.items() if k in sample},
            # the DR16 analysis samples bias_eta_LYA + beta_LYA for the
            # forest and fixes bias_eta_QSO = 1 with beta_QSO floating
            # (reference: examples/eBOSS_DR16/main_combined.ini:92-93)
            'bias_beta_config': {'LYA': 'bias_eta_beta',
                                 'QSO': 'bias_eta_beta'},
        }
        main_path = builder.build(
            {k: dict(v) for k, v in correlations.items()}, fit_type,
            fit_info, out, parameters=dict(PARAMETERS),
            name_extension=label)
        print(f'{label}: {main_path}')


if __name__ == '__main__':
    main()
