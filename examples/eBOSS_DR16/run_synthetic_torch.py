"""Self-contained eBOSS-DR16-style analysis on synthetic data, with the
PyTorch port (vega_tpu_torch) on the GPU.

Counterpart of run_synthetic.py in this directory, with its functions
(build_configs, regenerate_from_truth, make_global_cov, run_fit) under
the same names; the interfaces run on `device`, the card unless the
caller or --device says otherwise.

Reproduces the STRUCTURE of the DR16 flagship analysis (reference:
examples/eBOSS_DR16/main_combined.ini) without the SDSS download: four
correlations (two Lya auto regions + two QSO crosses) with the DR16
model options (Rogers2018 HCD, Arinyo small-scale NL, BAO broadening,
Lorentz velocity dispersion, metals), data vectors drawn from the
model's own truth, and three fits:

  1. auto     (lyaxlya + lyaxlyb)           — ap/at + nuisance sampled
  2. cross    (lyaxqso + lybxqso)
  3. combined (all four, per-corr covariances)
  4. combined-globalcov (all four through one joint covariance — the
     global-covariance code path, reference: vega_interface.py:888-954)

Each fit must recover the injected truth (ap = at = 1) within errors.

Run from this directory (or anywhere):
  python run_synthetic_torch.py [--workdir DIR] [--tiny] [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from vega_tpu_torch.build_config import BuildConfig            # noqa: E402
from vega_tpu_torch.io.fits import read_fits, write_fits      # noqa: E402
from vega_tpu_torch.testing import (_write_correlation_data,  # noqa: E402
                                    metal_rp_shifts, write_metal_file)
from vega_tpu_torch.vega_interface import VegaInterface       # noqa: E402

OPTIONS = {
    'scale_params': 'ap_at',
    'template': 'PlanckDR16/PlanckDR16.fits',
    'small_scale_nl': True,
    'bao_broadening': True,
    'hcd_model': 'Rogers2018',
    'velocity_dispersion': 'lorentz',
    'metals': ['SiII(1260)', 'SiIII(1207)'],
    'test': True,       # identity metal matrices (no picca metal files)
}

PARAMETERS = {
    'ap': 1.0, 'at': 1.0, 'bao_amp': 1.,
    'bias_LYA': -0.117, 'beta_LYA': 1.67, 'alpha_LYA': 2.9,
    'bias_hcd': -0.052, 'beta_hcd': 0.65, 'L0_hcd': 10.,
    'bias_QSO': 3.7, 'beta_QSO': 0.26, 'alpha_QSO': 1.44,
    'drp_QSO': 0.0, 'sigma_velo_disp_lorentz_QSO': 6.86,
    'bias_SiII(1260)': -0.002, 'beta_SiII(1260)': 0.5,
    'alpha_SiII(1260)': 1.,
    'bias_SiIII(1207)': -0.004, 'beta_SiIII(1207)': 0.5,
    'alpha_SiIII(1207)': 1.,
    'sigmaNL_per': 3.24, 'sigmaNL_par': 6.37, 'growth_rate': 0.97,
}

SAMPLED = ['ap', 'at', 'bias_LYA', 'beta_LYA']

# The full Table-6-style sampled set (reference:
# examples/eBOSS_DR16/main_combined.ini [sample]): BAO + Lya bias/RSD +
# HCD + the metal biases + the QSO cross nuisances. ALL FOUR nonlinear
# scale parameters (ap, at, drp_QSO, sigma_velo_disp_lorentz_QSO) are
# known grid parameters, so the whole set rides the grid-collapse fast
# path out of the box — ap/at on the production +-0.25 window, drp and
# sigma over their full sampling limits ([-3, 3] and [0, 15]). The
# 4-dim node tensor would be ~147k sweep evaluations; the anisotropic
# combination schedule (gridcollapse.plan_components) sweeps ~8k
# instead, with the payload validated against held-out exact collapse
# points (probe_err) at build time.
SAMPLED_FULL = SAMPLED + [
    'bias_hcd', 'beta_hcd',
    'bias_SiII(1260)', 'bias_SiIII(1207)',
    'drp_QSO', 'sigma_velo_disp_lorentz_QSO',
]

# Production run: the defaults ARE the production settings — no
# narrowing needed since the combination schedule keeps the sweep
# affordable.
CONTROL_FULL = {}

# CI-sized node budget for the slow-tier test (tests/test_dr16_example
# .py): same code path (4-dim combination schedule), ~2k swept nodes.
CONTROL_FULL_TEST = {
    'grid-nodes-ap': '16', 'grid-nodes-at': '16',
    'grid-nodes-drp_QSO': '8',
    'grid-nodes-sigma_velo_disp_lorentz_QSO': '6',
}

CORRS = {                     # name -> (file stem, is_cross)
    'lyaxlya': ('cf_lya', False),
    'lyaxlyb': ('cf_lyb', False),
    'lyaxqso': ('xcf_lya', True),
    'lybxqso': ('xcf_lyb', True),
}

FIT_TYPES = {
    'auto': 'lyaxlya_lyaxlyb',
    'cross': 'lyaxqso_lybxqso',
    'combined': 'lyaxlya_lyaxlyb_lyaxqso_lybxqso',
}


def build_configs(workdir, nt, extension=None, global_cov_file=None,
                  fit_types=None, sample_params=None, control_extra=None):
    rng = np.random.default_rng(0)
    correlations = {}
    for name, (stem, is_cross) in CORRS.items():
        path = workdir / f'{stem}.fits'
        metal_path = workdir / f'metal_{stem}.fits'
        if not path.exists():
            coords = _write_correlation_data(path, is_cross, 2.33, rng,
                                             nt=nt)
            metals = OPTIONS['metals']
            # Physical line-misidentification rp offsets (puts the
            # SiIII(1207) bump at ~21 Mpc/h and keeps the two metal
            # lines distinguishable — i.e. their biases non-degenerate)
            shifts = metal_rp_shifts(metals, 2.33)
            write_metal_file(metal_path, coords, 2.33,
                             'QSO' if is_cross else 'LYA', 'LYA',
                             metals_in1=() if is_cross else metals,
                             metals_in2=metals, rp_shifts=shifts)
        correlations[name] = {'corr_path': str(path),
                              'metal_path': str(metal_path),
                              'rp-min': -200. if is_cross else 0.}

    mains = {}
    for label, fit_type in (fit_types or FIT_TYPES).items():
        builder = BuildConfig(options=dict(OPTIONS), overwrite=True)
        fit_info = {'fitter': True, 'zeff': 2.33,
                    'sample_params': list(sample_params or SAMPLED)}
        if global_cov_file is not None:
            fit_info['global_cov_file'] = str(global_cov_file)
        name_ext = label if extension is None else f'{label}-{extension}'
        mains[label] = builder.build(
            correlations, fit_type, fit_info, workdir,
            parameters=dict(PARAMETERS), name_extension=name_ext)
        if control_extra:
            _append_control(mains[label], control_extra)
    return mains


def _append_control(main_path, extra):
    """Merge extra [control] keys into a generated main.ini."""
    import configparser
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read(main_path)
    if 'control' not in config:
        config['control'] = {}
    config['control'].update(extra)
    with open(main_path, 'w') as f:
        config.write(f)


def regenerate_from_truth(workdir, main_path, nt, device='cuda'):
    """Second pass: replace the placeholder data vectors with the model
    evaluated at the injected truth (mirrors vega_tpu_torch.testing)."""
    vega = VegaInterface(main_path, device=device)
    model_cf = vega.compute_model(run_init=False)
    rng = np.random.default_rng(1)
    for name, corr_item in vega.corr_items.items():
        stem, is_cross = CORRS[name]
        _write_correlation_data(workdir / f'{stem}.fits', is_cross, 2.33,
                                rng, model_xi=np.asarray(model_cf[name]),
                                nt=nt)


def make_global_cov(workdir, main_path, device='cuda'):
    """Block-diagonal joint covariance over the four correlations."""
    vega = VegaInterface(main_path, device=device)
    blocks = [read_fits(workdir / f'{CORRS[name][0]}.fits')[1]['CO']
              for name in vega.corr_items]
    n = sum(len(b) for b in blocks)
    cov = np.zeros((n, n))
    off = 0
    for b in blocks:
        cov[off:off + len(b), off:off + len(b)] = b
        off += len(b)
    path = workdir / 'global_cov.fits'
    write_fits(path, [{'name': 'COV', 'columns': {'COV': cov}}])
    return path


def run_fit(label, main_path, sampled=SAMPLED, device='cuda'):
    vega = VegaInterface(main_path, device=device)
    vega.minimize()
    values = dict(vega.bestfit.values)
    errors = dict(vega.bestfit.errors)
    print(f'\n=== {label}: chi2 = {vega.chisq:.2f} '
          f'(reduced {vega.reduced_chisq:.3f}) ===')
    for par in sampled:
        truth = PARAMETERS[par]
        pull = (values[par] - truth) / max(errors[par], 1e-12)
        print(f'  {par:10s} = {values[par]:+.4f} +- {errors[par]:.4f} '
              f'(truth {truth:+.4f}, pull {pull:+.2f})')
        assert abs(pull) < 5, f'{label}: {par} recovery failed'
    return values, errors


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--tiny', action='store_true',
                        help='smaller grids for a quick smoke run')
    parser.add_argument('--full-params', action='store_true',
                        help='sample the full Table-6-style parameter '
                             'set (BAO + HCD + metal biases + QSO cross '
                             'nuisances) in the combined fit')
    parser.add_argument('--device', default='cuda',
                        help="'cuda', 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)
    device = args.device

    workdir = Path(args.workdir or tempfile.mkdtemp(prefix='dr16_synth_'))
    workdir.mkdir(parents=True, exist_ok=True)
    nt = 20 if args.tiny else 50
    print(f'workdir: {workdir}')

    mains = build_configs(workdir, nt)
    regenerate_from_truth(workdir, mains['combined'], nt, device)

    fits = {}
    for label in ('auto', 'cross', 'combined'):
        fits[label] = run_fit(label, mains[label], device=device)

    if args.full_params:
        fmains = build_configs(
            workdir, nt, extension='full',
            fit_types={'combined': FIT_TYPES['combined']},
            sample_params=SAMPLED_FULL, control_extra=CONTROL_FULL)
        fits['combined-full-params'] = run_fit(
            'combined-full-params', fmains['combined'],
            sampled=SAMPLED_FULL, device=device)

    # Global-covariance variant of the combined fit
    gcov = make_global_cov(workdir, mains['combined'], device)
    gmains = build_configs(workdir, nt, extension='gcov',
                           global_cov_file=gcov,
                           fit_types={'combined': FIT_TYPES['combined']})
    fits['combined-globalcov'] = run_fit('combined-globalcov',
                                         gmains['combined'], device=device)

    print('\nAll four fits recover the injected truth.')
    return fits


if __name__ == '__main__':
    main()
