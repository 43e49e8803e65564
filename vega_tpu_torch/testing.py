"""Self-contained synthetic datasets for tests, benchmarks and demos.

Generates a complete fit setup (fiducial template, correlation data FITS,
main.ini + per-correlation ini) in a target directory with no external
data dependencies. The data vectors are drawn from the framework's own
model at fiducial parameters, so fits have a known truth.

Port of vega_tpu/testing.py: the same files, with the second pass (the
data vectors regenerated from the model) going through this package's
VegaInterface, so a machine without JAX can build the configuration.
`metals=` adds what vega_tpu's DR16 example writes by hand
(examples/eBOSS_DR16/run_synthetic.py:106-125): one metal file per
correlation, a [metals] section and `test = True` (identity metal
matrices); with `new_metals=True` instead the stacked-delta weights files
and a [metal-matrix] section, from which the model computes its metal
matrices (the DESI DR1 set-up, examples/DESI_data_setup/make_configs.py).
`global_cov=True` writes the block-diagonal joint covariance as
vega_tpu's does. `make_dr16_published_dataset` writes eBOSS DR16's
flagship configuration as examples/eBOSS_DR16/make_configs.py builds it
(four correlations, the DR16 compatibility switches, the sky residual),
on synthetic data. `make_desi_mock_dataset` and `make_lyacolore_dataset`
write the two mock configurations of examples/DESI_mock_setup and
examples/lyacolore_mocks (full-shape smoothing, the DR9LyaMocks
template).
"""

from __future__ import annotations

import configparser
import re
from pathlib import Path

import numpy as np

from .coordinates import Coordinates
from .io.fits import write_fits
from .models.eisenstein_hu import make_fiducial_template

DEFAULT_PARAMS = {
    'ap': 1.0, 'at': 1.0, 'bao_amp': 1.0,
    'bias_LYA': -0.117, 'beta_LYA': 1.67, 'alpha_LYA': 2.9,
    'bias_QSO': 3.7, 'beta_QSO': 0.26, 'alpha_QSO': 1.44,
    'drp_QSO': 0.0, 'sigma_velo_disp_lorentz_QSO': 6.86,
    'sigmaNL_per': 3.24, 'sigmaNL_par': 6.37,
    'growth_rate': 0.97,
}

# Omega_m of the fiducial template (models/eisenstein_hu.py), written to
# a data file's header (OMEGAM) when the new-metals matrices need the
# distances of its cosmology
OMEGA_M = 0.315


# The DR16-shaped model on the synthetic dataset: the options and
# parameters of vega_tpu's DR16 example
# (examples/eBOSS_DR16/run_synthetic.py:37-60: Rogers HCD, Arinyo
# small-scale NL, metals with identity metal matrices) with all four Si
# lines of the published fits; the two further SiII lines and the Arinyo
# parameters take vega_tpu/templates/parameter_defaults.ini's values.
DR16_METALS = ('SiII(1190)', 'SiII(1193)', 'SiII(1260)', 'SiIII(1207)')
DR16_MODEL_OPTIONS = {'model-hcd': 'Rogers2018',
                      'small scale nl': 'dnl_arinyo'}
DR16_PARAMETERS = {
    'bias_hcd': -0.052, 'beta_hcd': 0.65, 'L0_hcd': 10.,
    'bias_SiII(1190)': -0.0052, 'beta_SiII(1190)': 0.5,
    'alpha_SiII(1190)': 1.,
    'bias_SiII(1193)': -0.0024, 'beta_SiII(1193)': 0.5,
    'alpha_SiII(1193)': 1.,
    'bias_SiII(1260)': -0.002, 'beta_SiII(1260)': 0.5,
    'alpha_SiII(1260)': 1.,
    'bias_SiIII(1207)': -0.004, 'beta_SiIII(1207)': 0.5,
    'alpha_SiIII(1207)': 1.,
    'dnl_arinyo_q1': 0.303, 'dnl_arinyo_kv': 0.576, 'dnl_arinyo_av': 0.443,
    'dnl_arinyo_bv': 1.66, 'dnl_arinyo_kp': 11.062, 'dnl_arinyo_q2': 0.267,
}


def dr16_extra_model(parameters=None):
    """The `extra_model` text of the DR16-shaped model: its [model]
    options, then a [parameters] section with the parameters they and the
    metals read (each correlation's ini carries them; the main ini's
    [parameters] are `DEFAULT_PARAMS`). With
    `make_synthetic_dataset(..., extra_model=dr16_extra_model(),
    metals=DR16_METALS)` this is the configuration synthetic-dr16."""
    parameters = DR16_PARAMETERS if parameters is None else parameters
    return ('\n'.join(f'{k} = {v}' for k, v in DR16_MODEL_OPTIONS.items())
            + '\n\n[parameters]\n'
            + '\n'.join(f'{k} = {v}' for k, v in parameters.items()) + '\n')


# eBOSS DR16's combined-fit sampled set ("Table 6", the reference's
# examples/eBOSS_DR16/main_combined.ini; benchmarks/table6_accuracy.json:
# 3-17) on the DR16-shaped model, each bias_eta_X replaced by the
# synthetic configuration's bias_X: [sample] entries (lower, upper,
# start, error) with vega_tpu/parameters/default_values.txt's limits and
# errors and starts near the truth. drp_QSO in [-3, 3] and
# sigma_velo_disp_lorentz_QSO in [0, 15] are grid dimensions beside (ap,
# at): the payload is ap, at x 32, drp_QSO, sigma_velo x 12, swept as the
# combination schedule's 7,737 nodes. With `make_synthetic_dataset(...,
# metals=DR16_METALS, extra_model=dr16_extra_model(),
# sample=TABLE6_SAMPLE)` this is the configuration
# synthetic-dr16-table6.
TABLE6_SAMPLE = {
    'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
    'beta_LYA': '0.0 3.0 1.6 0.1', 'beta_QSO': '0.0 1.0 0.25 0.1',
    'beta_hcd': '0.0 5.0 0.7 0.1', 'bias_LYA': '-1.0 0.0 -0.12 0.01',
    'bias_SiII(1190)': '-0.5 0.0 -0.005 0.001',
    'bias_SiII(1193)': '-0.5 0.0 -0.0025 0.001',
    'bias_SiII(1260)': '-0.5 0.0 -0.0025 0.001',
    'bias_SiIII(1207)': '-0.5 0.0 -0.0035 0.001',
    'bias_hcd': '-0.5 0.0 -0.05 0.01',
    'drp_QSO': '-3.0 3.0 0.1 0.1',
    'sigma_velo_disp_lorentz_QSO': '0.0 15.0 6.5 0.1',
}


# The DESI DR1 baseline model on the synthetic dataset
# (examples/DESI_data_setup/make_configs.py:37-63,116-117): the DR16
# model's Rogers HCD and Arinyo NL, the DESI instrumental systematics on
# the auto, the QSO radiation on the cross, and the metals below, whose
# matrices the model computes from stacked-delta weights (new_metals,
# rebin by 3); parameters of make_configs.py:116-117 and
# vega_tpu/templates/parameter_defaults.ini.
DESI_METALS = ('SiII(1190)', 'SiII(1193)', 'SiIII(1207)', 'SiII(1260)',
               'CIV(eff)')
DESI_PARAMETERS = {
    'bias_hcd': -0.05, 'beta_hcd': 0.7, 'L0_hcd': 10.,
    'bias_SiII(1190)': -0.0052, 'beta_SiII(1190)': 0.5,
    'alpha_SiII(1190)': 1.,
    'bias_SiII(1193)': -0.0024, 'beta_SiII(1193)': 0.5,
    'alpha_SiII(1193)': 1.,
    'bias_SiIII(1207)': -0.0074, 'beta_SiIII(1207)': 0.5,
    'alpha_SiIII(1207)': 1.,
    'bias_SiII(1260)': -0.0046, 'beta_SiII(1260)': 0.5,
    'alpha_SiII(1260)': 1.,
    'bias_CIV(eff)': -0.01, 'beta_CIV(eff)': 0.5, 'alpha_CIV(eff)': 0.,
    'dnl_arinyo_q1': 0.303, 'dnl_arinyo_kv': 0.576, 'dnl_arinyo_av': 0.443,
    'dnl_arinyo_bv': 1.66, 'dnl_arinyo_kp': 11.062, 'dnl_arinyo_q2': 0.267,
    'qso_rad_strength': 0.74, 'qso_rad_asymmetry': 0.,
    'qso_rad_lifetime': 9e99, 'qso_rad_decrease': 300.,
    'desi_inst_sys_amp': 0.00032,
}
# DESI's sampled names and Gaussian priors (make_configs.py:51-63)
DESI_SAMPLED = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_QSO',
                'sigma_velo_disp_lorentz_QSO', 'drp_QSO', 'qso_rad_strength',
                'bias_hcd', 'beta_hcd', 'L0_hcd',
                'bias_SiII(1190)', 'bias_SiII(1193)', 'bias_SiIII(1207)',
                'bias_SiII(1260)', 'bias_CIV(eff)', 'desi_inst_sys_amp')
DESI_PRIORS = {
    'drp_QSO': 'gaussian 0.0 0.1',
    'beta_hcd': 'gaussian 0.50 0.09',
    'L0_hcd': 'gaussian 5.0 2.0',
    'bias_CIV(eff)': 'gaussian -0.019 0.005',
    'sigma_velo_disp_lorentz_QSO': 'gaussian 5.21 0.85',
}
# [metal-matrix]: vega_tpu/build_config.py:293-309's defaults, rebinned
# by 3 as DESI's rebin-metals = 3
METAL_MATRIX = {
    'rebin_factor': '3', 'alpha_LYA': '2.9', 'alpha_SiII(1260)': '1.',
    'alpha_SiIII(1207)': '1.', 'alpha_SiII(1193)': '1.',
    'alpha_SiII(1190)': '1.', 'alpha_CIV(eff)': '0.',
    'z_ref_objects': '2.25', 'z_evol_objects': '1.44',
    'z_bins_objects': '1000',
}


def desi_extra_model(parameters=None):
    """The `extra_model` of the DESI-shaped model, per correlation:
    {'auto': text, 'cross': text}, each the DR16 model's [model] options
    with the DESI term of that correlation, then a [parameters] section.
    With `make_synthetic_dataset(..., extra_model=desi_extra_model(),
    metals=DESI_METALS, new_metals=True, global_cov=True)` this is the
    configuration synthetic-desi."""
    parameters = DESI_PARAMETERS if parameters is None else parameters
    block = ('\n\n[parameters]\n'
             + '\n'.join(f'{k} = {v}' for k, v in parameters.items()) + '\n')
    options = '\n'.join(f'{k} = {v}' for k, v in DR16_MODEL_OPTIONS.items())
    return {'auto': options + '\ndesi-instrumental-systematics = True'
            + block,
            'cross': options + '\nradiation effects = True' + block}


# BuildConfig's small-scale marginalization once switched on
# (vega_tpu/build_config.py:105-115,325-341): the distorted scales each
# correlation's r-min cut leaves out, a prior of 10, those bins fitted
# and one template per data bin. With make_synthetic_dataset(...,
# cross=True, metals=DESI_METALS, new_metals=True, with_distortion=True,
# extra_model=marg_extra_model(desi_extra_model()),
# sample=DESI_MARG_SAMPLE) this is the configuration synthetic-desi-marg
# (per-correlation covariances); with `with_control(main,
# 'marginalize-in-fit = True', path)` the templates are fitted per
# evaluation instead of entering the covariance.
MARG_MODEL = {'marginalize-all-rmin-cuts': 'True',
              'marginalize-prior-sigma': '10.0',
              'fit-marginalized-scales': 'True',
              'marginalize-match-data-bins': 'True'}
# [sample] entries (lower, upper, start, error) of its fits: (ap, at) on
# the grid, the LYA and QSO biases and beta_LYA in the coefficient
# program; DESI_MOCK_FIT_SAMPLE's limits, errors and starts
DESI_MARG_SAMPLE = {
    'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
    'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1',
    'bias_QSO': '0.0 6.0 3.6 0.1'}


def marg_extra_model(extra_model=''):
    """`extra_model` (text, or {'auto': text, 'cross': text}) with
    MARG_MODEL's options first in each correlation's [model]."""
    lines = '\n'.join(f'{k} = {v}' for k, v in MARG_MODEL.items()) + '\n'
    if isinstance(extra_model, dict):
        return {k: lines + v for k, v in extra_model.items()}
    return lines + extra_model


# DESI DR1's baseline as run on mocks
# (examples/DESI_mock_setup/make_configs.py:18-30): the DESI model with
# Gaussian full-shape smoothing in [model] and in [metals], no Arinyo
# term, no instrumental systematics, the four Si lines without CIV(eff),
# and DESI's sampled names without bias_CIV(eff) and desi_inst_sys_amp.
# The example writes no smoothing width (BuildConfig writes them only when
# given, vega_tpu/build_config.py:729-735), and then vega_tpu raises
# KeyError at the first evaluation; the widths here are the per-tracer
# pairs of LYA and QSO and the Si pairs' `_metals` pair at
# vega_tpu/templates/parameter_defaults.ini's 2.0 (ROADMAP.md §3).
DESI_MOCK_METALS = DESI_METALS[:4]
DESI_MOCK_SMOOTHING = {f'{axis}_sigma_smooth_{group}': 2.
                       for group in ('LYA', 'QSO', 'metals')
                       for axis in ('par', 'per')}
DESI_MOCK_PARAMETERS = {
    **{k: v for k, v in DESI_PARAMETERS.items()
       if 'CIV' not in k and not k.startswith('dnl_arinyo')
       and k != 'desi_inst_sys_amp'},
    **DESI_MOCK_SMOOTHING}
DESI_MOCK_SAMPLED = tuple(n for n in DESI_SAMPLED
                          if n not in ('bias_CIV(eff)', 'desi_inst_sys_amp'))
DESI_MOCK_PRIORS = {k: v for k, v in DESI_PRIORS.items()
                    if k in DESI_MOCK_SAMPLED}
# [sample] entries (lower, upper, start, error) of a fit of the DESI mock:
# default_values.txt's limits and errors, starts off the truth; L0_hcd's
# upper limit raised from 10, where its value sits, to 30. The grid
# regime's names: (ap, at) on the grid, the linear names in the
# coefficient program (L0_hcd and the QSO nuisances, which shape grids,
# fixed).
DESI_MOCK_FIT_SAMPLE = {
    'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
    'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1',
    'bias_QSO': '0.0 6.0 3.6 0.1',
    'sigma_velo_disp_lorentz_QSO': '0.0 15.0 6.5 0.5',
    'drp_QSO': '-3.0 3.0 0.1 0.1', 'qso_rad_strength': '0.0 2.0 0.7 0.1',
    'bias_hcd': '-0.5 0.0 -0.055 0.01', 'beta_hcd': '0.0 5.0 0.65 0.1',
    'L0_hcd': '0.0 30.0 9.0 1.0',
    'bias_SiII(1190)': '-0.5 0.0 -0.005 0.001',
    'bias_SiII(1193)': '-0.5 0.0 -0.0025 0.001',
    'bias_SiIII(1207)': '-0.5 0.0 -0.007 0.001',
    'bias_SiII(1260)': '-0.5 0.0 -0.0045 0.001',
}
DESI_MOCK_GRID_NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_QSO',
                        'qso_rad_strength', 'bias_hcd', 'beta_hcd',
                        'bias_SiII(1190)', 'bias_SiII(1193)',
                        'bias_SiIII(1207)', 'bias_SiII(1260)')
# the mock's [model] and [metals] options (MOCK_OPTIONS)
DESI_MOCK_SMOOTHING_OPTION = 'fullshape smoothing = gauss\n'


def desi_mock_extra_model(parameters=None):
    """The `extra_model` of the DESI mock configuration, per correlation
    ({'auto', 'cross'}): Rogers HCD, the QSO radiation on the cross and
    the full-shape smoothing, then a [parameters] section
    (DESI_MOCK_PARAMETERS by default)."""
    parameters = DESI_MOCK_PARAMETERS if parameters is None else parameters
    block = ('\n\n[parameters]\n'
             + '\n'.join(f'{k} = {v}' for k, v in parameters.items()) + '\n')
    hcd = f'model-hcd = {DR16_MODEL_OPTIONS["model-hcd"]}\n'
    return {'auto': hcd + DESI_MOCK_SMOOTHING_OPTION + block,
            'cross': hcd + 'radiation effects = True\n'
            + DESI_MOCK_SMOOTHING_OPTION + block}


def make_desi_mock_dataset(workdir, size='full', device='cuda', seed=0,
                           sample=None, extra_control=''):
    """DESI DR1's baseline as run on mocks on the synthetic auto + cross
    dataset; returns the main ini's path. `make_synthetic_dataset` with
    the new-metals matrices of DESI_MOCK_METALS, `desi_mock_extra_model()`
    and the smoothing option in each [metals] section; [priors] of
    DESI_MOCK_PRIORS after `extra_control`. `sample` ({name: [sample]
    entry}) defaults to DESI_MOCK_SAMPLED at their default_values.txt
    limits. Per-correlation covariances: the grid payload serves them."""
    sample = ({name: 'True' for name in DESI_MOCK_SAMPLED}
              if sample is None else sample)
    return make_synthetic_dataset(
        workdir, cross=True, size=size, device=device, sample=sample,
        seed=seed, extra_model=desi_mock_extra_model(),
        metals=list(DESI_MOCK_METALS), new_metals=True,
        extra_metals=DESI_MOCK_SMOOTHING_OPTION,
        extra_control=extra_control + priors_section(
            {k: v for k, v in DESI_MOCK_PRIORS.items() if k in sample}))


# The reference's own model terms on the DR16-shaped model
# (synthetic-dr16-uv): the DR16 model of `dr16_extra_model` with the UV
# background's fluctuations and shot noise in both correlations' [model]
# sections (the reference's base main.ini turns UVB-fluctuations on in
# every correlation, tests/tools/variant_configs.py:256-257), and on the
# cross the relativistic correction, the standard asymmetry and Croom's
# QSO bias evolution (`qso_z_evol='croom'` of make_synthetic_dataset);
# the [metals] sections do not set them, so the metals stay stacked.
# Parameters of vega_tpu/templates/parameter_defaults.ini. Sampled: the
# DR16 model's eight names and one of each new term's.
DR16_UV_PARAMETERS = {
    **DR16_PARAMETERS,
    'bias_gamma': 0.1125, 'bias_prim': -0.66, 'lambda_uv': 300.,
    'uv_shotnoise_amp': 0., 'Arel1': -13.5, 'Arel3': 1., 'Aasy0': 1.,
    'Aasy2': 1., 'Aasy3': 1., 'croom_par0': 0.53, 'croom_par1': 0.289,
}
DR16_UV_SAMPLED = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_hcd',
                   'beta_hcd', 'bias_SiII(1260)', 'bias_SiIII(1207)',
                   'bias_gamma', 'uv_shotnoise_amp', 'Arel1', 'Aasy0')
# [sample] entries (lower, upper, start, error): the DR16 names' of
# tests/tools/make_torch_port_dr16_goldens.py, bias_gamma at
# default_values.txt's limits, and limits around parameter_defaults.ini's
# value for the shotnoise amplitude (its default, 0, would be a bound)
# and the two amplitudes default_values.txt lacks; the starts lie off the
# truth, for a fit from them
DR16_UV_SAMPLE = {
    'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
    'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1',
    'bias_hcd': '-0.5 0.0 -0.05 0.01', 'beta_hcd': '0.0 5.0 0.7 0.1',
    'bias_SiII(1260)': '-0.5 0.0 -0.0025 0.001',
    'bias_SiIII(1207)': '-0.5 0.0 -0.0035 0.001',
    'bias_gamma': '-1.0 1.0 0.1 0.01',
    'uv_shotnoise_amp': '-1.0 1.0 0.0005 0.001',
    'Arel1': '-40.0 20.0 -13.0 1.0', 'Aasy0': '-10.0 10.0 1.2 0.5'}


def dr16_uv_extra_model(parameters=None):
    """The `extra_model` of synthetic-dr16-uv, {'auto', 'cross'}: the
    DR16 model's options, the UV lines, on the cross the relativistic
    and asymmetry lines, then the [parameters]
    (`DR16_UV_PARAMETERS` unless given)."""
    parameters = DR16_UV_PARAMETERS if parameters is None else parameters
    uv = 'UVB-fluctuations = True\nUVB-shotnoise = True\n'
    cross = 'relativistic correction = True\nstandard asymmetry = True\n'
    return {'auto': uv + dr16_extra_model(parameters),
            'cross': uv + cross + dr16_extra_model(parameters)}


def make_dr16_uv_dataset(workdir, size='full', device='cuda', seed=0,
                         sample=None, extra_control=''):
    """synthetic-dr16-uv: `make_synthetic_dataset` with DR16_METALS,
    `dr16_uv_extra_model()` and Croom's QSO evolution on the cross;
    `sample` ({name: [sample] entry}) defaults to DR16_UV_SAMPLE.
    Returns the main ini's path."""
    sample = DR16_UV_SAMPLE if sample is None else sample
    return make_synthetic_dataset(
        workdir, cross=True, size=size, device=device, sample=sample,
        seed=seed, extra_control=extra_control, metals=DR16_METALS,
        extra_model=dr16_uv_extra_model(), qso_z_evol='croom')


def with_omega_m(path, omega_m):
    """Rewrite a correlation data file with OMEGAM in its first table's
    header, the cosmology the split bias evolution and the new-metals
    matrices read (the header keys the data layer reads are kept)."""
    from .io.fits import read_fits
    hdul = read_fits(path)
    hdus = []
    for i, hdu in enumerate(hdul[1:]):
        header = {k: v for k, v in hdu.header.items()
                  if k in ('RPMIN', 'RPMAX', 'RTMAX', 'NP', 'NT', 'BLINDING')}
        if i == 0:
            header['OMEGAM'] = omega_m
        hdus.append({'name': hdu.name, 'header': header,
                     'columns': dict(hdu.columns)})
    write_fits(path, hdus)


def dataset_variant(main, workdir, auto='', cross='', parameters='',
                    auto_metals=True, omega_m=None, qso_z_evol=None):
    """A copy of a synthetic dataset's files in `workdir` with lines
    added at the top of each correlation's [model] (`auto`, `cross`) and
    [parameters] (`parameters`, both), the auto's [metals] section
    removed (`auto_metals=False`; it must be the ini's last section),
    OMEGAM written to the cross's data file, or the cross's `z evol QSO`
    model replaced. Returns the copy's main ini."""
    import shutil
    source, workdir = Path(main).parent, Path(workdir)
    shutil.copytree(source, workdir)
    for path in workdir.iterdir():
        if path.suffix != '.ini':
            continue
        text = path.read_text().replace(str(source), str(workdir))
        line = {'lyaxlya': auto, 'qsoxlya': cross}.get(path.stem)
        if line is not None:
            text = text.replace('[model]\n', f'[model]\n{line}', 1)
            text = text.replace('[parameters]\n',
                                f'[parameters]\n{parameters}', 1)
            if path.stem == 'lyaxlya' and not auto_metals:
                text = text[:text.index('[metals]')]
            if path.stem == 'qsoxlya':
                text = with_qso_z_evol(text, qso_z_evol)
        path.write_text(text)
    if omega_m is not None:
        with_omega_m(workdir / 'xcf_synthetic.fits', omega_m)
    return workdir / 'main.ini'


def priors_section(priors):
    """A [priors] section (for `extra_control`, which may open sections)."""
    return '\n[priors]\n' + '\n'.join(f'{k} = {v}'
                                        for k, v in priors.items()) + '\n'


def new_metals_weights(seed=0):
    """The stacked-delta weights of the new-metals matrices, from
    np.random.default_rng([seed, 1]) (a stream apart from the data's):
    {'stack': {LOGLAM, WEIGHT}, 'catalog': {Z}}, a forest stack on the
    eBOSS / picca grid (log10 lambda from 3600 to 5772 A in steps of
    1e-4, 2051 pixels, 683 after rebinning by 3) and a QSO catalogue of
    400,000 redshifts over [1.8, 4.0] (1000 z bins)."""
    rng = np.random.default_rng([seed, 1])
    loglam = np.arange(np.log10(3600.), np.log10(5772.), 1e-4)
    return {'stack': {'LOGLAM': loglam,
                      'WEIGHT': rng.uniform(0.5, 2.0, loglam.size)},
            'catalog': {'Z': rng.uniform(1.8, 4.0, 400_000)}}


def new_metals_lines(stack_file, catalog_file, is_cross):
    """([data] lines, [model] lines, the [metal-matrix] section) of one
    correlation in the new-metals mode, as vega_tpu's BuildConfig writes
    them (vega_tpu/build_config.py:282-309)."""
    data = (f'weights-tracer1 = {catalog_file if is_cross else stack_file}\n'
            f'weights-tracer2 = {stack_file}\nzmin = 0.0\nzmax = 10.0\n')
    model = 'new_metals = True\nrp_only_metal_mats = False\n'
    section = '[metal-matrix]\n' + '\n'.join(
        f'{k} = {v}' for k, v in METAL_MATRIX.items()) + '\n'
    return data, model, section


def _auto_ini(data_file, name='lyaxlya', extra_model='', extra_data=''):
    return f"""[data]
name = {name}
tracer1 = LYA
tracer2 = LYA
tracer1-type = continuous
tracer2-type = continuous
filename = {data_file}
{extra_data}
[cuts]
rp-min = 0.
rp-max = +200.
rt-min = 0.
rt-max = 200.
r-min = 10.
r-max = 180.
mu-min = -1.
mu-max = +1.

[model]
z evol LYA = bias_vs_z_std
{extra_model}
"""


def _cross_ini(data_file, name='qsoxlya', extra_model='', extra_data=''):
    return f"""[data]
name = {name}
tracer1 = QSO
tracer2 = LYA
tracer1-type = discrete
tracer2-type = continuous
filename = {data_file}
{extra_data}
[cuts]
rp-min = -200.
rp-max = +200.
rt-min = 0.
rt-max = 200.
r-min = 10.
r-max = 180.
mu-min = -1.
mu-max = +1.

[model]
z evol LYA = bias_vs_z_std
z evol QSO = bias_vs_z_std
velocity dispersion = lorentz
{extra_model}
"""


def _main_ini(ini_files, template_file, out_file, sample=None, zeff=2.33,
              global_cov_file=None, extra_control=''):
    sample = sample or {'bias_LYA': 'True', 'beta_LYA': 'True'}
    sample_block = '\n'.join(f'{k} = {v}' for k, v in sample.items())
    params_block = '\n'.join(f'{k} = {v}' for k, v in DEFAULT_PARAMS.items())
    global_cov_line = (f'global-cov-file = {global_cov_file}'
                       if global_cov_file else '')
    return f"""[data sets]
zeff = {zeff}
ini files = {' '.join(str(f) for f in ini_files)}
{global_cov_line}

[cosmo-fit type]
cosmo fit func = ap_at

[fiducial]
filename = {template_file}

[control]
{extra_control}

[output]
filename = {out_file}

[sample]
{sample_block}

[parameters]
{params_block}
"""


def _write_correlation_data(path, is_cross, z_eff, rng, model_xi=None,
                            noise=0.0, nt=50, with_distortion=False,
                            omega_m=None):
    """Write a picca-export-style correlation FITS file with synthetic
    contents (same layout as reference tests/data/*-exp.fits.gz); with
    `omega_m` the header also carries the cosmology (OMEGAM)."""
    if is_cross:
        coords = Coordinates(-200., 200., 200., 2 * nt, nt)
    else:
        coords = Coordinates(0., 200., 200., nt, nt)
    n = coords.rp_grid.size

    if model_xi is None:
        # A smooth placeholder correlation with a BAO-like bump
        r = np.maximum(coords.r_grid, 1.0)
        model_xi = (5e-3 / r ** 1.5 * (1 + 0.3 * np.exp(
            -(r - 105.0) ** 2 / (2 * 15.0 ** 2))))

    # Realistic per-bin uncertainties (S/N ~ 20) so synthetic fits are
    # well-conditioned; written as a diagonal covariance. `noise` sigmas
    # of Gaussian noise from `rng` (drawn even when noise = 0, as
    # vega_tpu draws them, so a seed gives the same files)
    sigma = 1e-6 + 0.05 * np.abs(model_xi)
    da = model_xi + noise * sigma * rng.normal(size=n)
    cov = np.diag(sigma ** 2)
    z = np.full(n, z_eff)
    nb = np.full(n, 1000, dtype=np.int64)

    header = {
        'RPMIN': coords.rp_min, 'RPMAX': coords.rp_max,
        'RTMAX': coords.rt_max, 'NP': coords.rp_nbins,
        'NT': coords.rt_nbins, 'BLINDING': 'none',
    }
    if omega_m is not None:
        header['OMEGAM'] = omega_m
    columns = {'RP': coords.rp_grid, 'RT': coords.rt_grid, 'Z': z,
               'DA': da, 'CO': cov, 'NB': nb}
    if with_distortion:
        # A mild smoothing distortion along rt (banded, row-normalized)
        dm = np.eye(n) * 0.9
        off = np.eye(n, k=1) * 0.05 + np.eye(n, k=-1) * 0.05
        dm = dm + off
        dm /= dm.sum(axis=1, keepdims=True)
        columns['DM'] = dm
    write_fits(path, [
        {'name': 'COR', 'header': header, 'columns': columns},
        {'name': 'DMATTRI',
         'columns': {'DMRP': coords.rp_grid, 'DMRT': coords.rt_grid,
                     'DMZ': z}},
    ])
    return coords


def metal_rp_shifts(metals, z_eff, main_absorber='LYA', omega_m=0.315):
    """Physical line-of-sight coordinate offsets (Mpc/h) for absorbers of
    each metal line misidentified as `main_absorber`: an absorber at
    observed wavelength w assumed to sit at z_assumed = w/lambda_main - 1
    truly sits at z_true = w/lambda_metal - 1, so its comoving position
    is off by r(z_true) - r(z_assumed). This is what puts the SiIII(1207)
    contamination bump at rp ~ 21 Mpc/h in the DR16 auto-correlation
    (vega_tpu/testing.py:160-178)."""
    from .cosmo import ABSORBER_IGM, Cosmo
    cosmo = Cosmo(Om=omega_m)
    lam_main = ABSORBER_IGM[main_absorber]
    wave = lam_main * (1.0 + z_eff)     # observed wavelength at z_eff
    shifts = {}
    for m in metals:
        z_true = wave / ABSORBER_IGM[m] - 1.0
        shifts[m] = float(cosmo.get_r_comov(z_true)
                          - cosmo.get_r_comov(z_eff))
    return shifts


def write_metal_file(path, coords, z_eff, tracer1, tracer2,
                     metals_in1=(), metals_in2=(), rp_shifts=None):
    """Write a picca-style metal file with coordinate columns for every
    metal pair a Data reader may request (RP_/RT_/Z_ per pair name, both
    orders), and NO distortion columns: with `test = True` in [data]
    the reader substitutes identity metal matrices
    (vega_tpu/testing.py:181-228).

    rp_shifts: optional {absorber: Mpc/h offset} (see metal_rp_shifts).
    When given, each pair's RP column is offset by the difference of its
    two absorbers' shifts (main tracers shift by 0), mimicking the
    shifted effective separations real picca metal files carry and
    making different metal lines distinguishable in a fit."""
    pair_names = set()
    for m in metals_in2:
        pair_names.add(f'{tracer1}_{m}')
        pair_names.add(f'{m}_{tracer1}')
    for m in metals_in1:
        pair_names.add(f'{m}_{tracer2}')
        pair_names.add(f'{tracer2}_{m}')
    for m1 in metals_in1:
        for m2 in metals_in2:
            pair_names.add(f'{m1}_{m2}')
            pair_names.add(f'{m2}_{m1}')

    n = coords.rp_grid.size
    z = np.full(n, z_eff)
    header = {
        'RPMIN': coords.rp_min, 'RPMAX': coords.rp_max,
        'RTMAX': coords.rt_max, 'NP': coords.rp_nbins,
        'NT': coords.rt_nbins, 'BLINDING': 'none',
    }
    shifts = rp_shifts or {}
    columns = {}
    for name in sorted(pair_names):
        # pair names are '<abs1>_<abs2>'; absorber names themselves
        # contain no underscores (LYA, QSO, SiII(1260), ...)
        a1, a2 = name.rsplit('_', 1)
        dshift = shifts.get(a2, 0.0) - shifts.get(a1, 0.0)
        columns[f'RP_{name}'] = coords.rp_grid + dshift
        columns[f'RT_{name}'] = coords.rt_grid
        columns[f'Z_{name}'] = z
    write_fits(path, [
        {'name': 'ATTRI', 'header': header,
         'columns': {'DUMMY': np.zeros(1)}},
        {'name': 'MDMAT', 'columns': columns},
    ])
    return path


def metals_section(metal_file, metals, is_cross, extra=''):
    """The [metals] section of one correlation's ini, as vega_tpu's
    BuildConfig writes it (vega_tpu/build_config.py:264-272,317-319):
    the legacy metal file, the standard bias evolution, the metals in
    each continuous tracer, and for the cross the [model] section's
    velocity dispersion; then the lines of `extra` (the section's own
    model options, as build_config.py:361-381 adds them)."""
    lines = ['[metals]', f'filename = {metal_file}',
             'z evol = bias_vs_z_std']
    if not is_cross:
        lines.append('in tracer1 = ' + ' '.join(metals))
    lines.append('in tracer2 = ' + ' '.join(metals))
    if is_cross:
        lines.append('velocity dispersion = lorentz')
    return '\n'.join(lines) + '\n' + extra


def with_qso_z_evol(text, qso_z_evol):
    """An ini's text with its `z evol QSO` model replaced (unchanged for
    None or an ini without the line)."""
    if qso_z_evol is None:
        return text
    return re.sub(r'z evol QSO = \S+', f'z evol QSO = {qso_z_evol}', text,
                  count=1)


def make_synthetic_dataset(workdir, cross=True, size='full', device='cuda',
                           sample=None, seed=0, noise=0.0, extra_control='',
                           with_distortion=False, extra_model='',
                           metals=None, new_metals=False, global_cov=False,
                           extra_metals='', qso_z_evol=None):
    """Create a complete synthetic fit setup; returns the main.ini path.

    The files equal vega_tpu.testing.make_synthetic_dataset's, given the
    same `sample` ({name: [sample] entry}; default bias_LYA and beta_LYA
    sampled), `seed` and `noise` (Gaussian noise in units of each bin's
    sigma, from np.random.default_rng(seed); default none),
    `extra_control` (text placed under [control], which may open further
    sections such as [monte carlo] or [priors]), `with_distortion` (a
    banded DM matrix), `extra_model` (text placed at the end of each
    correlation's [model] section, which may open a [parameters] section
    for the parameters its options read; a dict {'auto': text, 'cross':
    text} gives each correlation its own) and `global_cov` (a
    block-diagonal joint covariance of the per-correlation ones in
    `global_cov.fits`, named by [data sets] global-cov-file). size='tiny'
    shrinks every axis (k grid, mu_k bins, rp/rt bins) for fast checks.

    `metals` (a list of absorber names such as 'SiII(1260)'; vega_tpu's
    function has no such option, its examples do this by hand) puts the
    metals in every LYA tracer with a [metals] section
    (`metals_section`) after `extra_model`; the metals' parameters go in
    `extra_model`'s [parameters]. Their matrices come from
    `metal_<data file>` beside each data file (`write_metal_file`,
    `metal_rp_shifts`; `test = True` in [data]: identity metal
    matrices), or with `new_metals=True` from the stacked-delta weights
    files `delta_stack.fits` and `qso_catalog.fits`
    (`new_metals_weights(seed)`), the lines of `new_metals_lines` and
    OMEGAM in the data files' headers. `extra_metals` (text) ends each
    [metals] section. `qso_z_evol` (e.g. 'croom') replaces the cross's
    `z evol QSO = bias_vs_z_std` line of [model].

    `device` is where the second pass evaluates the model: the card
    unless the caller asks for 'cpu'; asking for CUDA without a GPU
    raises before any file is written.
    """
    from .io.fits import read_fits
    from .vega_interface import VegaInterface, resolve_device
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    tiny = size == 'tiny'
    n_k = 128 if tiny else 814
    nt = 10 if tiny else 50
    model_lines = ('num_bins_muk = 50\nell_max = 6\n' if tiny else '')
    if not isinstance(extra_model, dict):
        extra_model = {'auto': extra_model, 'cross': extra_model}

    template_file = workdir / 'fiducial_eh98.fits'
    make_fiducial_template(template_file, n_k=n_k)

    z_eff = 2.33
    omega_m = None
    stack_file = workdir / 'delta_stack.fits'
    catalog_file = workdir / 'qso_catalog.fits'
    if metals and new_metals:
        omega_m = OMEGA_M
        weights = new_metals_weights(seed)
        write_fits(stack_file, [{'name': 'STACK',
                                 'columns': weights['stack']}])
        write_fits(catalog_file, [{'name': 'CAT',
                                   'columns': weights['catalog']}])
    ini_files = []
    data_files = {}
    for is_cross, stem, ini_name, ini_text in (
            (False, 'cf_synthetic', 'lyaxlya.ini', _auto_ini),
            (True, 'xcf_synthetic', 'qsoxlya.ini', _cross_ini))[:1 + cross]:
        data_file = data_files[is_cross] = workdir / f'{stem}.fits'
        coords = _write_correlation_data(
            data_file, is_cross, z_eff, rng, noise=noise, nt=nt,
            with_distortion=with_distortion, omega_m=omega_m)
        lines = model_lines + extra_model['cross' if is_cross else 'auto']
        extra_data = ''
        if metals and new_metals:
            extra_data, new_model, matrix_section = new_metals_lines(
                stack_file, catalog_file, is_cross)
            lines = (new_model + lines + '\n'
                     + metals_section('None', metals, is_cross,
                                      extra_metals)
                     + '\n' + matrix_section)
        elif metals:
            metal_file = workdir / f'metal_{stem}.fits'
            write_metal_file(
                metal_file, coords, z_eff, 'QSO' if is_cross else 'LYA',
                'LYA', metals_in1=() if is_cross else metals,
                metals_in2=metals,
                rp_shifts=metal_rp_shifts(metals, z_eff))
            lines += '\n' + metals_section(metal_file, metals, is_cross,
                                            extra_metals)
            extra_data = 'test = True\n'
        ini_files.append(workdir / ini_name)
        ini_files[-1].write_text(with_qso_z_evol(
            ini_text(data_file, extra_model=lines, extra_data=extra_data),
            qso_z_evol))

    main_path = workdir / 'main.ini'
    main_path.write_text(_main_ini(
        ini_files, template_file, workdir / 'output', sample=sample,
        zeff=z_eff, extra_control=extra_control))

    # Second pass: regenerate the data vectors from the actual model at
    # the default parameters so fits are well-posed (truth = defaults)
    vega = VegaInterface(main_path, device=device)
    model_cf = vega.compute_model(run_init=False)
    for name, corr_item in vega.corr_items.items():
        is_cross = corr_item.tracer1['type'] != corr_item.tracer2['type']
        _write_correlation_data(data_files[is_cross], is_cross, z_eff, rng,
                                model_xi=np.asarray(model_cf[name]),
                                noise=noise, nt=nt,
                                with_distortion=with_distortion,
                                omega_m=omega_m)

    if global_cov:
        # block-diagonal joint covariance of the per-correlation ones
        # (vega_tpu/testing.py:299-316)
        blocks = []
        for name, corr_item in vega.corr_items.items():
            is_cross = corr_item.tracer1['type'] != corr_item.tracer2['type']
            blocks.append(read_fits(data_files[is_cross])[1]['CO'])
        n_total = sum(b.shape[0] for b in blocks)
        cov = np.zeros((n_total, n_total))
        off = 0
        for b in blocks:
            cov[off:off + len(b), off:off + len(b)] = b
            off += len(b)
        global_cov_file = workdir / 'global_cov.fits'
        write_fits(global_cov_file, [{'name': 'COV',
                                      'columns': {'COV': cov}}])
        main_path.write_text(_main_ini(
            ini_files, template_file, workdir / 'output', sample=sample,
            zeff=z_eff, global_cov_file=global_cov_file,
            extra_control=extra_control))

    return main_path


# eBOSS DR16 as published (du Mas des Bourboux et al. 2020, Table 6): the
# combined auto + cross fit of examples/eBOSS_DR16/make_configs.py, whose
# dictionaries vega_tpu's BuildConfig turns into these ini sections
# (vega_tpu/build_config.py:222-419,494-560): DR16_OPTIONS (:45-56:
# Rogers HCD, Arinyo NL in the autos, BAO broadening, Lorentzian velocity
# dispersion, five metals through the metal files with fast_metals,
# bias_eta parameters), DR16_EXTRA_MODEL (:59-60), the sky-residual
# broadband SKY_BB in both autos (:62), binsize 4 (par / per binsize
# <name> in each correlation's [parameters]), PARAMETERS (:96-121) and
# PRIORS (:91-94), and the combined fit's 18 sampled names (:174-177).
# `test = True` under [data] reads identity metal matrices from metal
# files without distortion columns. With make_dr16_published_dataset this
# is the configuration synthetic-dr16-published.
DR16PUB_CORRELATIONS = ('lyaxlya', 'lyaxlyb', 'lyaxqso', 'lybxqso')
DR16PUB_METALS = ('CIV(eff)', 'SiII(1260)', 'SiIII(1207)', 'SiII(1193)',
                  'SiII(1190)')
DR16PUB_ZEFF = 2.334
DR16PUB_EXTRA_MODEL = {'old_fftlog': 'True', 'old_growth_func': 'True',
                       'ell-max': '6'}
DR16PUB_SKY_BB = {'bb1': 'add pre rp,rt 0:0:1 0:0:1 broadband_sky'}
# the main [parameters] BuildConfig resolves from PARAMETERS and the sky
# defaults of make_configs.py's sky_params (in its order and text)
DR16PUB_PARAMETERS = {
    'ap': '1.0', 'at': '1.0', 'sigmaNL_per': '3.24',
    'sigmaNL_par': '6.36984', 'bao_amp': '1.0',
    'beta_LYA': '1.669', 'bias_eta_LYA': '-0.201',
    'growth_rate': '0.970386', 'alpha_LYA': '2.9',
    'beta_QSO': '0.26', 'bias_eta_QSO': '1', 'alpha_QSO': '1.44',
    'dnl_arinyo_q1': '0.303', 'dnl_arinyo_q2': '0.267',
    'dnl_arinyo_kv': '0.576', 'dnl_arinyo_av': '0.443',
    'dnl_arinyo_bv': '1.66', 'dnl_arinyo_kp': '11.062',
    'bias_hcd': '-0.0523', 'beta_hcd': '0.646', 'L0_hcd': '10.0',
    'drp_QSO': '0.0', 'sigma_velo_disp_lorentz_QSO': '6.86',
    'bias_eta_CIV(eff)': '-0.0052', 'beta_CIV(eff)': '0.27',
    'alpha_CIV(eff)': '1.0',
    'bias_eta_SiII(1260)': '-0.0027', 'beta_SiII(1260)': '0.5',
    'alpha_SiII(1260)': '1.0',
    'bias_eta_SiIII(1207)': '-0.0045', 'beta_SiIII(1207)': '0.5',
    'alpha_SiIII(1207)': '1.0',
    'bias_eta_SiII(1193)': '-0.002', 'beta_SiII(1193)': '0.5',
    'alpha_SiII(1193)': '1.0',
    'bias_eta_SiII(1190)': '-0.0029', 'beta_SiII(1190)': '0.5',
    'alpha_SiII(1190)': '1.0',
    'BB-lyaxlya-0-broadband_sky-scale-sky': '0.01',
    'BB-lyaxlya-0-broadband_sky-sigma-sky': '31.0',
    'BB-lyaxlyb-0-broadband_sky-scale-sky': '0.01',
    'BB-lyaxlyb-0-broadband_sky-sigma-sky': '31.0',
}
SKY_NAMES = tuple(f'BB-{name}-0-broadband_sky-{kind}-sky'
                  for name in ('lyaxlya', 'lyaxlyb')
                  for kind in ('scale', 'sigma'))
# the combined fit's [sample] (make_configs.py:66-89,174-177)
DR16PUB_SAMPLE = {
    'ap': 'True', 'at': 'True', 'bias_eta_LYA': 'True', 'beta_LYA': 'True',
    'bias_hcd': 'True', 'beta_hcd': 'True',
    **{f'bias_eta_{m}': '-0.02 0. -0.003 0.01'
       for m in ('SiII(1260)', 'SiIII(1207)', 'SiII(1193)', 'SiII(1190)',
                 'CIV(eff)')},
    'drp_QSO': 'True', 'sigma_velo_disp_lorentz_QSO': 'True',
    'beta_QSO': 'True',
    **{name: ('0 0.5 0.01 0.1' if 'scale' in name else '10 60 31. 0.1')
       for name in SKY_NAMES},
}
DR16PUB_PRIORS = {'beta_hcd': 'gaussian 0.5 0.09',
                  'bias_eta_CIV(eff)': 'gaussian -0.005 0.0026'}
# With the components written ([output] write_pk / write_cf), both
# packages refuse the configuration as published: fast_metals raises
# ValueError at construction and the metals' bias product outside their
# spectra (fast_metal_bias, on by default) AssertionError at the first
# saved evaluation (vega_tpu/metals.py:65-69,505-506). The departure their
# messages ask for, in each correlation's [model] (ROADMAP.md §3); the
# growth rate is not sampled, so the model is the published one.
DR16PUB_COMPONENTS_MODEL = {'fast_metals': 'False',
                            'fast_metal_bias': 'False'}


def _ini_parser():
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    return config


def dr16_published_correlation(name, data_file, metal_file, size='full',
                               components=False):
    """One correlation's ini of the published configuration, as
    vega_tpu's BuildConfig writes it from make_configs.py's `corr_info`
    (a ConfigParser; size='tiny' adds the synthetic configuration's
    small mu_k grid to [model]; components=True the departure
    DR16PUB_COMPONENTS_MODEL)."""
    is_cross = name.endswith('xqso')
    tracer2 = ('QSO', 'discrete') if is_cross else ('LYA', 'continuous')
    config = _ini_parser()
    config['data'] = {
        'name': name, 'tracer1': 'LYA', 'tracer2': tracer2[0],
        'tracer1-type': 'continuous', 'tracer2-type': tracer2[1],
        'filename': str(data_file), 'test': 'True'}
    config['cuts'] = {
        'rp-min': '-200.0' if is_cross else '0.0', 'rp-max': '+300.',
        'rt-min': '0', 'rt-max': '300.', 'r-min': '10.0', 'r-max': '180.0',
        'mu-min': '-1', 'mu-max': '1'}
    model = {'z evol LYA': 'bias_vs_z_std'}
    if is_cross:
        model['z evol QSO'] = 'bias_vs_z_std'
    else:
        model['small scale nl'] = 'dnl_arinyo'
        model['use_metal_autos'] = 'True'
    model['model-hcd'] = 'Rogers2018'
    model['fast_metals'] = 'True'
    if is_cross:
        model['velocity dispersion'] = 'lorentz'
    model['marginalize-all-rmin-cuts'] = 'False'
    model.update(DR16PUB_EXTRA_MODEL)
    if size == 'tiny':
        model.update(num_bins_muk='50', ell_max='6')
    if components:
        model.update(DR16PUB_COMPONENTS_MODEL)
    config['model'] = model
    config['parameters'] = {f'par binsize {name}': '4',
                            f'per binsize {name}': '4'}
    metals = ' '.join(DR16PUB_METALS)
    config['metals'] = {'filename': str(metal_file),
                        'z evol': 'bias_vs_z_std', 'in tracer1': metals}
    if is_cross:
        config['metals']['velocity dispersion'] = 'lorentz'
    else:
        config['metals']['in tracer2'] = metals
    if not is_cross:
        config['broadband'] = dict(DR16PUB_SKY_BB)
    return config


def dr16_published_main(ini_files, template_file, out_file, sample=None,
                        extra_control=None, components=False):
    """The main ini of the published configuration, as BuildConfig
    writes it (a ConfigParser): the combined fit's [sample] and [priors]
    unless `sample` ({name: [sample] entry}) is given, [control] with
    `extra_control` ({option: value}) beside run_sampler, and with
    `components` write_pk and write_cf under [output]."""
    sample = DR16PUB_SAMPLE if sample is None else sample
    config = _ini_parser()
    config['data sets'] = {
        'zeff': str(DR16PUB_ZEFF),
        'ini files': ' '.join(str(f) for f in ini_files)}
    config['cosmo-fit type'] = {
        'cosmo fit func': 'ap_at', 'full-shape': 'False',
        'full-shape-alpha': 'False', 'smooth-scaling': 'False'}
    config['fiducial'] = {'filename': str(template_file)}
    config['output'] = {'filename': str(out_file)}
    if components:
        config['output'].update(write_pk='True', write_cf='True')
    config['sample'] = dict(sample)
    priors = {k: v for k, v in DR16PUB_PRIORS.items() if k in sample}
    if priors:
        config['priors'] = priors
    config['parameters'] = dict(DR16PUB_PARAMETERS)
    config['control'] = {'run_sampler': 'False', **(extra_control or {})}
    return config


def make_dr16_published_dataset(workdir, size='full', device='cuda', seed=0,
                                sample=None, extra_control=None,
                                components=False, files_from=None):
    """eBOSS DR16's published configuration on synthetic data; returns the
    main ini's path. Four correlations (lyaxlya, lyaxlyb: 2500 bins each;
    lyaxqso, lybxqso: 5000 bins each at size='full'), the files of
    `make_synthetic_dataset` otherwise: the fiducial template, picca-style
    data files drawn from np.random.default_rng(seed) and then replaced
    by the model at the configuration's parameters (evaluated on
    `device`, the card unless the caller asks for 'cpu'), and a metal
    file per correlation (`write_metal_file`, rp shifts of the five
    metals). `sample` replaces the combined fit's [sample];
    `extra_control` ({option: value}) goes under [control]; components=True
    writes the components ([output] write_pk / write_cf) with the
    departure DR16PUB_COMPONENTS_MODEL. `files_from`, the directory of an
    earlier call at the same size, lends that call's template, data and
    metal files: only the ini files are written in `workdir`, and no
    model is evaluated."""
    from .vega_interface import VegaInterface, resolve_device
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    source = workdir if files_from is None else Path(files_from)
    rng = np.random.default_rng(seed)
    tiny = size == 'tiny'
    nt = 10 if tiny else 50
    template_file = source / 'fiducial_eh98.fits'
    data_files = {n: source / f'cf_{n}.fits' for n in DR16PUB_CORRELATIONS}
    metal_files = {n: source / f'metal_{n}.fits'
                   for n in DR16PUB_CORRELATIONS}
    crosses = {n: n.endswith('xqso') for n in DR16PUB_CORRELATIONS}
    if files_from is None:
        make_fiducial_template(template_file, n_k=128 if tiny else 814)
        for name in DR16PUB_CORRELATIONS:
            coords = _write_correlation_data(data_files[name], crosses[name],
                                             DR16PUB_ZEFF, rng, nt=nt)
            write_metal_file(
                metal_files[name], coords, DR16PUB_ZEFF, 'LYA',
                'QSO' if crosses[name] else 'LYA',
                metals_in1=DR16PUB_METALS,
                metals_in2=() if crosses[name] else DR16PUB_METALS,
                rp_shifts=metal_rp_shifts(DR16PUB_METALS, DR16PUB_ZEFF))
    ini_files = []
    for name in DR16PUB_CORRELATIONS:
        ini_files.append(workdir / f'{name}.ini')
        with open(ini_files[-1], 'w') as fh:
            dr16_published_correlation(name, data_files[name],
                                       metal_files[name], size,
                                       components).write(fh)
    # BuildConfig's output directory and run name
    (workdir / 'output_fitter').mkdir(exist_ok=True)
    main_path = workdir / 'main.ini'
    with open(main_path, 'w') as fh:
        dr16_published_main(
            ini_files, template_file,
            workdir / 'output_fitter' / '_'.join(DR16PUB_CORRELATIONS),
            sample, extra_control, components).write(fh)
    if files_from is not None:
        return main_path

    # the data vectors: the model at the configuration's parameters
    model_cf = VegaInterface(main_path, device=device).compute_model(
        run_init=False)
    for name in DR16PUB_CORRELATIONS:
        _write_correlation_data(data_files[name], crosses[name],
                                DR16PUB_ZEFF, rng,
                                model_xi=np.asarray(model_cf[name]), nt=nt)
    return main_path


# The LyaCoLoRe raw-mock auto-correlation
# (examples/lyacolore_mocks/make_configs.py:23-62): LYA x LYA on the
# DR9LyaMocks template (read by path from vega_tpu/models), Gaussian
# full-shape smoothing with par_sigma_smooth and per_sigma_smooth sampled
# (2.4 each), no small-scale NL, no BAO broadening (sigmaNL 0), no metals,
# the cuts r in [10, 180], rp >= 0. The ini sections are BuildConfig's
# (vega_tpu/build_config.py:222-419,494-760) for these options, with one
# departure: `old_fftlog = True` in [model] (LYACOLORE_EXTRA_MODEL, given
# to BuildConfig as the correlation's extra-model). The template's k grid
# is log-spaced to 0.8% only, and the FFTLog operator of both packages
# refuses it (ValueError, ops/fftlog.py); the legacy transform reads it
# as it is (ROADMAP.md §3).
LYACOLORE_EXTRA_MODEL = {'old_fftlog': 'True'}
LYACOLORE_TEMPLATE = 'DR9LyaMocks/DR9LyaMocks.fits'
LYACOLORE_ZEFF = 2.33
LYACOLORE_SAMPLED = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'par_sigma_smooth',
                     'per_sigma_smooth')


def lyacolore_parameters(zeff=LYACOLORE_ZEFF):
    """The main [parameters] BuildConfig resolves for the example (its
    template's values, the Lya bias of build_config.py:755-757 at zeff,
    the smoothing widths make_configs.py passes)."""
    bias = -0.1167 * ((1 + zeff) / (1 + 2.334)) ** 2.9
    return {'ap': '1.0', 'at': '1.0', 'sigmaNL_per': '0.0',
            'sigmaNL_par': '0.0', 'bao_amp': '1.', 'bias_LYA': str(bias),
            'beta_LYA': '1.67', 'alpha_LYA': '2.9',
            'par_sigma_smooth': '2.4', 'per_sigma_smooth': '2.4'}


def lyacolore_correlation(data_file, size='full'):
    """The auto-correlation's ini, as BuildConfig writes it (a
    ConfigParser; size='tiny' adds the small mu_k grid to [model])."""
    config = _ini_parser()
    config['data'] = {
        'name': 'lyaxlya', 'tracer1': 'LYA', 'tracer2': 'LYA',
        'tracer1-type': 'continuous', 'tracer2-type': 'continuous',
        'filename': str(data_file)}
    config['cuts'] = {
        'rp-min': '0.0', 'rp-max': '+300.', 'rt-min': '0', 'rt-max': '300.',
        'r-min': '10.0', 'r-max': '180.0', 'mu-min': '-1', 'mu-max': '1'}
    model = {'z evol LYA': 'bias_vs_z_std', 'use_metal_autos': 'True',
             'marginalize-all-rmin-cuts': 'False', **LYACOLORE_EXTRA_MODEL}
    if size == 'tiny':
        model.update(num_bins_muk='50', ell_max='6')
    model['fullshape smoothing'] = 'gauss'
    config['model'] = model
    return config


def lyacolore_main(ini_file, out_file, sample=None, extra_control=None):
    """The main ini, as BuildConfig writes it (a ConfigParser): [sample]
    the six names of the example unless `sample` ({name: [sample] entry})
    is given, [control] with `extra_control` ({option: value})."""
    config = _ini_parser()
    config['data sets'] = {'zeff': str(LYACOLORE_ZEFF),
                           'ini files': str(ini_file)}
    config['cosmo-fit type'] = {
        'cosmo fit func': 'ap_at', 'full-shape': 'False',
        'full-shape-alpha': 'False', 'smooth-scaling': 'False'}
    config['fiducial'] = {'filename': LYACOLORE_TEMPLATE}
    config['output'] = {'filename': str(out_file)}
    config['sample'] = ({name: 'True' for name in LYACOLORE_SAMPLED}
                        if sample is None else dict(sample))
    config['parameters'] = lyacolore_parameters()
    config['control'] = {'run_sampler': 'False', **(extra_control or {})}
    return config


def make_lyacolore_dataset(workdir, size='full', device='cuda', seed=0,
                           sample=None, extra_control=None):
    """The LyaCoLoRe raw-mock auto fit on synthetic data; returns the main
    ini's path. One LYA x LYA data file (2500 bins at size='full', 100 at
    'tiny') drawn from np.random.default_rng(seed), then replaced by the
    model at the configuration's parameters (evaluated on `device`, the
    card unless the caller asks for 'cpu'); the DR9LyaMocks template at
    both sizes. `sample` replaces the example's [sample];
    `extra_control` ({option: value}) goes under [control]."""
    from .vega_interface import VegaInterface, resolve_device
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    nt = 10 if size == 'tiny' else 50
    data_file = workdir / 'cf_lyaxlya.fits'
    _write_correlation_data(data_file, False, LYACOLORE_ZEFF, rng, nt=nt)
    ini_file = workdir / 'lyaxlya.ini'
    with open(ini_file, 'w') as fh:
        lyacolore_correlation(data_file, size).write(fh)
    (workdir / 'output_fitter').mkdir(exist_ok=True)
    main_path = workdir / 'main.ini'
    with open(main_path, 'w') as fh:
        lyacolore_main(ini_file, workdir / 'output_fitter' / 'lyaxlya',
                       sample, extra_control).write(fh)
    model_cf = VegaInterface(main_path, device=device).compute_model(
        run_init=False)
    _write_correlation_data(data_file, False, LYACOLORE_ZEFF, rng,
                            model_xi=np.asarray(model_cf['lyaxlya']), nt=nt)
    return main_path


# [sample] entries of a fit of the LyaCoLoRe configuration: the six names
# at default_values.txt's limits and errors, starts off the truth
LYACOLORE_FIT_SAMPLE = {
    'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
    'bias_LYA': '-1.0 0.0 -0.11 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1',
    'par_sigma_smooth': '0.0 10.0 2.2 0.1',
    'per_sigma_smooth': '0.0 10.0 2.6 0.1',
}


def with_control(main_ini, lines, path, sections=''):
    """Write a copy of the main ini `main_ini` at `path` (which may be
    `main_ini`) with `lines` ('option = value' lines) added to its
    [control] section and `sections` (ini text of further sections)
    after it; returns `path`."""
    config = _ini_parser()
    config.read(main_ini)
    if 'control' not in config:
        config['control'] = {}
    for line in lines.strip().splitlines():
        key, value = line.split('=', 1)
        config['control'][key.strip()] = value.strip()
    with open(path, 'w') as fh:
        config.write(fh)
        fh.write(sections)
    return Path(path)


def with_sample(main_ini, sample, path):
    """Write a copy of the main ini `main_ini` at `path` with [sample]
    replaced by `sample` ({name: entry}) and [priors] kept for its names;
    returns `path`."""
    config = _ini_parser()
    config.read(main_ini)
    config['sample'] = dict(sample)
    if 'priors' in config:
        priors = {k: v for k, v in config['priors'].items() if k in sample}
        config.remove_section('priors')
        if priors:
            config['priors'] = priors
    with open(path, 'w') as fh:
        config.write(fh)
    return Path(path)
