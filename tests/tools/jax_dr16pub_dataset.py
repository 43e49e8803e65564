"""The JAX package's (vega_tpu) side of eBOSS DR16's published
configuration on synthetic data.

examples/eBOSS_DR16/make_configs.py builds the flagship analysis with
vega_tpu's BuildConfig from the public data files.
`make_jax_dr16_published_dataset` runs the same BuildConfig on the same
dictionaries (the combined fit: four correlations, DR16_OPTIONS,
DR16_EXTRA_MODEL, SKY_BB, binsize 4, PARAMETERS, PRIORS, the 18 sampled
names) over synthetic data and metal files written by vega_tpu's own
functions, in the order of
vega_tpu_torch.testing.make_dr16_published_dataset, so the two packages'
files from the same arguments can be held against each other. Three
departures from make_configs.py, each also the port's: `test = True`
under [data] (identity metal matrices: the synthetic metal files carry
no distortion columns), [fiducial] names the synthetic template, and
size='tiny' adds the small mu_k grid (num_bins_muk = 50) to [model].
"""

from __future__ import annotations

import configparser
import importlib.util
import os
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CORRELATIONS = ('lyaxlya', 'lyaxlyb', 'lyaxqso', 'lybxqso')


def make_configs_module():
    """examples/eBOSS_DR16/make_configs.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        'dr16_make_configs', REPO / 'examples' / 'eBOSS_DR16'
        / 'make_configs.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def combined_sample(mc):
    """The combined fit's [sample] dictionary (make_configs.py:174-177)."""
    return {**mc.SAMPLED_BAO, **mc.SAMPLED_HCD, **mc.SAMPLED_METALS,
            **mc.SAMPLED_CROSS_COMBINED,
            **mc.sky_params(['lyaxlya', 'lyaxlyb'])}


def build_dr16_published_inis(workdir, size='full', sample=None):
    """BuildConfig's inis of the combined fit over the data and metal
    files `workdir/cf_<name>.fits`, `workdir/metal_<name>.fits`
    (main.ini and <name>.ini in workdir); returns main.ini's path."""
    from vega_tpu.build_config import BuildConfig
    mc = make_configs_module()
    correlations = {}
    for name in CORRELATIONS:
        info = mc.corr_info(workdir, name, f'cf_{name}.fits',
                            f'metal_{name}.fits', name.endswith('xqso'))
        if size == 'tiny':
            info['extra-model'].update(num_bins_muk='50', ell_max='6')
        correlations[name] = info
    sample = combined_sample(mc) if sample is None else sample
    writer = BuildConfig(options=dict(mc.DR16_OPTIONS, test=True),
                         overwrite=True)
    fit_info = {
        'fitter': True, 'run_sampler': False, 'zeff': 2.334,
        'sample_params': sample,
        'priors': {k: v for k, v in mc.PRIORS.items() if k in sample},
        'bias_beta_config': {'LYA': 'bias_eta_beta',
                             'QSO': 'bias_eta_beta'},
    }
    parameters = dict(mc.PARAMETERS)
    mc.sky_params(['lyaxlya', 'lyaxlyb'])      # the sky defaults
    parameters.update({k: v for k, v in mc.PARAMETERS.items()
                       if k.startswith('BB-')})
    return writer.build(correlations, '_'.join(CORRELATIONS), fit_info,
                         Path(workdir), parameters=parameters)


def make_jax_dr16_published_dataset(workdir, size='full', seed=0,
                                    sample=None, extra_control=None,
                                    components=False):
    """main.ini of the published configuration, its data vectors the
    model of vega_tpu at the configuration's parameters (the arguments
    are the port's make_dr16_published_dataset's; components=True writes
    the components with the port's DR16PUB_COMPONENTS_MODEL departure in
    each correlation's [model])."""
    from vega_tpu import testing as jt
    from vega_tpu.models.eisenstein_hu import make_fiducial_template
    from vega_tpu.vega_interface import VegaInterface

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tiny = size == 'tiny'
    nt = 10 if tiny else 50
    z_eff = 2.334
    metals = make_configs_module().DR16_OPTIONS['metals']
    template_file = workdir / 'fiducial_eh98.fits'
    make_fiducial_template(template_file, n_k=128 if tiny else 814)
    for name in CORRELATIONS:
        is_cross = name.endswith('xqso')
        coords = jt._write_correlation_data(workdir / f'cf_{name}.fits',
                                            is_cross, z_eff, rng, nt=nt)
        jt.write_metal_file(
            workdir / f'metal_{name}.fits', coords, z_eff, 'LYA',
            'QSO' if is_cross else 'LYA', metals_in1=metals,
            metals_in2=() if is_cross else metals,
            rp_shifts=jt.metal_rp_shifts(metals, z_eff))
    main_path = build_dr16_published_inis(workdir, size, sample)

    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(main_path)
    config['fiducial']['filename'] = str(template_file)
    for key, value in (extra_control or {}).items():
        config['control'][key] = value
    if components:
        config['output'].update(write_pk='True', write_cf='True')
        for path in config['data sets']['ini files'].split():
            corr = configparser.ConfigParser()
            corr.optionxform = lambda option: option
            corr.read(path)
            corr['model'].update(fast_metals='False',
                                 fast_metal_bias='False')
            with open(path, 'w') as fh:
                corr.write(fh)
    with open(main_path, 'w') as fh:
        config.write(fh)

    # the dense model: vega_tpu's factored fast path would build the grid
    # payload of the sampled names first (hours at full size on the CPU)
    factored = os.environ.get('VEGA_TPU_FACTORED')
    os.environ['VEGA_TPU_FACTORED'] = '0'
    try:
        model_cf = VegaInterface(main_path).compute_model(run_init=False)
    finally:
        if factored is None:
            del os.environ['VEGA_TPU_FACTORED']
        else:
            os.environ['VEGA_TPU_FACTORED'] = factored
    for name in CORRELATIONS:
        jt._write_correlation_data(
            workdir / f'cf_{name}.fits', name.endswith('xqso'), z_eff, rng,
            model_xi=np.asarray(model_cf[name]), nt=nt)
    return main_path


def configuration_variant(main_path, workdir, names=None, output=None,
                          model=None):
    """A copy of the configuration `main_path` in `workdir` (main.ini and
    each correlation's ini; the data, metal and template files are
    shared): only the correlations `names` (default all), with `output`
    ({option: value}) set in the main [output] and `model` in every
    correlation's [model]; returns the copy's main.ini path."""
    def parser(path):
        config = configparser.ConfigParser()
        config.optionxform = lambda option: option
        config.read(path)
        return config

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    main = parser(main_path)
    ini_files = []
    for path in main['data sets']['ini files'].split():
        corr = parser(path)
        if names is not None and corr['data']['name'] not in names:
            continue
        corr['model'].update(model or {})
        ini_files.append(workdir / Path(path).name)
        with open(ini_files[-1], 'w') as fh:
            corr.write(fh)
    main['data sets']['ini files'] = ' '.join(str(f) for f in ini_files)
    main['output'].update(output or {})
    out = workdir / 'main.ini'
    with open(out, 'w') as fh:
        main.write(fh)
    return out
