"""The JAX package's (vega_tpu) side of the two mock configurations.

- DESI DR1's baseline as run on mocks (examples/DESI_mock_setup):
  `make_jax_desi_mock_dataset` is make_jax_metal_dataset with the
  arguments of vega_tpu_torch.testing.make_desi_mock_dataset.
- The LyaCoLoRe raw-mock auto (examples/lyacolore_mocks):
  `build_lyacolore_inis` runs vega_tpu's BuildConfig on the example's
  OPTIONS, cuts, sampled names and parameters over a data file, and
  `make_jax_lyacolore_dataset` writes that data file with vega_tpu's own
  functions, in the order of vega_tpu_torch.testing.make_lyacolore_dataset,
  and replaces its data vector by vega_tpu's model. Departures from
  make_configs.py, each also the port's: the correlation's extra-model
  LYACOLORE_EXTRA_MODEL (old_fftlog: the template's k grid is not
  log-spaced enough for the FFTLog operator), zeff given rather than read
  off the data file, and size='tiny' adds the small mu_k grid
  (num_bins_muk = 50) to [model].
"""

from __future__ import annotations

import configparser
import importlib.util
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def example_module(folder):
    """examples/<folder>/make_configs.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f'{folder}_make_configs', REPO / 'examples' / folder
        / 'make_configs.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_jax_desi_mock_dataset(workdir, size='full', seed=0, sample=None,
                               extra_control=''):
    """main.ini of the DESI mock configuration, written and given its
    data vectors by vega_tpu (the arguments are the port's
    make_desi_mock_dataset's)."""
    from jax_metal_dataset import make_jax_metal_dataset
    from vega_tpu_torch.testing import (DESI_MOCK_METALS, DESI_MOCK_PRIORS,
                                        DESI_MOCK_SAMPLED,
                                        DESI_MOCK_SMOOTHING_OPTION,
                                        desi_mock_extra_model,
                                        priors_section)
    sample = ({name: 'True' for name in DESI_MOCK_SAMPLED}
              if sample is None else sample)
    return make_jax_metal_dataset(
        workdir, list(DESI_MOCK_METALS), cross=True, size=size,
        sample=sample, seed=seed, extra_model=desi_mock_extra_model(),
        new_metals=True, extra_metals=DESI_MOCK_SMOOTHING_OPTION,
        extra_control=extra_control + priors_section(
            {k: v for k, v in DESI_MOCK_PRIORS.items() if k in sample}))


def build_lyacolore_inis(workdir, data_file, size='full', sample=None,
                         extra_model=True):
    """BuildConfig's inis of the LyaCoLoRe example over `data_file`
    (main.ini and lyaxlya.ini in workdir); returns main.ini's path.
    extra_model=False leaves LYACOLORE_EXTRA_MODEL out, as the example
    writes the configuration."""
    from vega_tpu.build_config import BuildConfig
    from vega_tpu_torch.testing import (LYACOLORE_EXTRA_MODEL,
                                        LYACOLORE_ZEFF)
    mc = example_module('lyacolore_mocks')
    corr = {'corr_path': str(data_file), 'r-min': 10., 'r-max': 180.,
            'rp-min': 0.,
            'extra-model': dict(LYACOLORE_EXTRA_MODEL) if extra_model
            else {}}
    if size == 'tiny':
        corr['extra-model'].update(num_bins_muk='50', ell_max='6')
    fit_info = {'fitter': True, 'zeff': LYACOLORE_ZEFF,
                'sample_params': (['ap', 'at', 'bias_LYA', 'beta_LYA',
                                   'par_sigma_smooth', 'per_sigma_smooth']
                                  if sample is None else sample)}
    writer = BuildConfig(options=dict(mc.OPTIONS), overwrite=True)
    return writer.build({'lyaxlya': corr}, 'lyaxlya', fit_info,
                        Path(workdir), parameters={'par_sigma_smooth': 2.4,
                                                   'per_sigma_smooth': 2.4})


def make_jax_lyacolore_dataset(workdir, size='full', seed=0, sample=None,
                               extra_control=None):
    """main.ini of the LyaCoLoRe configuration, its data vector the model
    of vega_tpu at the configuration's parameters (the arguments are the
    port's make_lyacolore_dataset's)."""
    from vega_tpu import testing as jt
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import LYACOLORE_ZEFF

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    nt = 10 if size == 'tiny' else 50
    data_file = workdir / 'cf_lyaxlya.fits'
    jt._write_correlation_data(data_file, False, LYACOLORE_ZEFF, rng, nt=nt)
    main_path = build_lyacolore_inis(workdir, data_file, size, sample)
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(main_path)
    for key, value in (extra_control or {}).items():
        config['control'][key] = value
    with open(main_path, 'w') as fh:
        config.write(fh)
    model_cf = VegaInterface(main_path).compute_model(run_init=False)
    jt._write_correlation_data(data_file, False, LYACOLORE_ZEFF, rng,
                               model_xi=np.asarray(model_cf['lyaxlya']),
                               nt=nt)
    return main_path
