"""Self-contained synthetic datasets for tests, benchmarks and demos.

Generates a complete fit setup (fiducial template, correlation data FITS,
main.ini + per-correlation ini) in a target directory with no external
data dependencies. The data vectors are drawn from the framework's own
model at fiducial parameters, so fits have a known truth.

Port of vega_tpu/testing.py: the same files, with the second pass (the
data vectors regenerated from the model) going through this package's
VegaInterface, so a machine without JAX can build the configuration.
Metal files and the global covariance are not ported (neither are the
features that read them).
"""

from __future__ import annotations

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


def _auto_ini(data_file, name='lyaxlya', extra_model=''):
    return f"""[data]
name = {name}
tracer1 = LYA
tracer2 = LYA
tracer1-type = continuous
tracer2-type = continuous
filename = {data_file}

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


def _cross_ini(data_file, name='qsoxlya', extra_model=''):
    return f"""[data]
name = {name}
tracer1 = QSO
tracer2 = LYA
tracer1-type = discrete
tracer2-type = continuous
filename = {data_file}

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


def _main_ini(ini_files, template_file, out_file, sample=None, zeff=2.33):
    sample = sample or {'bias_LYA': 'True', 'beta_LYA': 'True'}
    sample_block = '\n'.join(f'{k} = {v}' for k, v in sample.items())
    params_block = '\n'.join(f'{k} = {v}' for k, v in DEFAULT_PARAMS.items())
    return f"""[data sets]
zeff = {zeff}
ini files = {' '.join(str(f) for f in ini_files)}


[cosmo-fit type]
cosmo fit func = ap_at

[fiducial]
filename = {template_file}

[control]


[output]
filename = {out_file}

[sample]
{sample_block}

[parameters]
{params_block}
"""


def _write_correlation_data(path, is_cross, z_eff, model_xi=None, nt=50):
    """Write a picca-export-style correlation FITS file with synthetic
    contents (same layout as reference tests/data/*-exp.fits.gz)."""
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
    # well-conditioned; written as a diagonal covariance. Noise-free: the
    # data vector is the model itself.
    sigma = 1e-6 + 0.05 * np.abs(model_xi)
    da = model_xi
    cov = np.diag(sigma ** 2)
    z = np.full(n, z_eff)
    nb = np.full(n, 1000, dtype=np.int64)

    header = {
        'RPMIN': coords.rp_min, 'RPMAX': coords.rp_max,
        'RTMAX': coords.rt_max, 'NP': coords.rp_nbins,
        'NT': coords.rt_nbins, 'BLINDING': 'none',
    }
    columns = {'RP': coords.rp_grid, 'RT': coords.rt_grid, 'Z': z,
               'DA': da, 'CO': cov, 'NB': nb}
    write_fits(path, [
        {'name': 'COR', 'header': header, 'columns': columns},
        {'name': 'DMATTRI',
         'columns': {'DMRP': coords.rp_grid, 'DMRT': coords.rt_grid,
                     'DMZ': z}},
    ])
    return coords


def make_synthetic_dataset(workdir, cross=True, size='full', device='cuda',
                           sample=None):
    """Create a complete synthetic fit setup; returns the main.ini path.

    The files equal vega_tpu.testing.make_synthetic_dataset's with its
    default options (noise-free, no distortion matrix) and the same
    `sample` ({name: [sample] entry}; default bias_LYA and beta_LYA
    sampled). size='tiny' shrinks every axis (k grid, mu_k bins, rp/rt
    bins) for fast checks. `device` is where the second pass evaluates
    the model: the card unless the caller asks for 'cpu'; asking for
    CUDA without a GPU raises before any file is written.
    """
    from .vega_interface import VegaInterface, resolve_device
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    tiny = size == 'tiny'
    n_k = 128 if tiny else 814
    nt = 10 if tiny else 50
    model_lines = ('num_bins_muk = 50\nell_max = 6\n' if tiny else '')

    template_file = workdir / 'fiducial_eh98.fits'
    make_fiducial_template(template_file, n_k=n_k)

    z_eff = 2.33
    auto_file = workdir / 'cf_synthetic.fits'
    _write_correlation_data(auto_file, False, z_eff, nt=nt)
    ini_files = [workdir / 'lyaxlya.ini']
    ini_files[0].write_text(_auto_ini(auto_file, extra_model=model_lines))

    cross_file = None
    if cross:
        cross_file = workdir / 'xcf_synthetic.fits'
        _write_correlation_data(cross_file, True, z_eff, nt=nt)
        cross_ini = workdir / 'qsoxlya.ini'
        cross_ini.write_text(_cross_ini(cross_file, extra_model=model_lines))
        ini_files.append(cross_ini)

    main_path = workdir / 'main.ini'
    main_path.write_text(_main_ini(
        ini_files, template_file, workdir / 'output', sample=sample,
        zeff=z_eff))

    # Second pass: regenerate the data vectors from the actual model at
    # the default parameters so fits are well-posed (truth = defaults)
    vega = VegaInterface(main_path, device=device)
    model_cf = vega.compute_model()
    for name, corr_item in vega.corr_items.items():
        is_cross = corr_item.tracer1['type'] != corr_item.tracer2['type']
        fname = cross_file if is_cross else auto_file
        _write_correlation_data(fname, is_cross, z_eff,
                                model_xi=np.asarray(model_cf[name]), nt=nt)

    return main_path
