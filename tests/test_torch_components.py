"""The model's saved components (save-components: [output] write_pk /
write_cf) in the PyTorch port against the JAX package (vega_tpu), on the
CPU at size='tiny', mirroring tests/test_save_components.py: the
components' key sets and values, with the metals decomposed and not, the
metal stacking guard, the refusals of fast_metals and of the metals'
fast bias, components saved by compute_model alone, and the PK_ / Xi_
HDUs read by either package. Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_dr16pub_dataset import (configuration_variant,  # noqa: E402
                                 make_jax_dr16_published_dataset)
from vega_tpu.io.fits import read_fits as jax_read_fits  # noqa: E402
from vega_tpu.testing import make_synthetic_dataset  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch.factored import Sampling  # noqa: E402
from vega_tpu_torch.io.fits import read_fits  # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

COMPONENT_RTOL = 1e-12  # a component, of its largest entry
SUM_RTOL = 1e-12        # bao_amp x peak + smooth against the model
COMPONENTS = ('pk', 'xi', 'xi_distorted')
PARTS = ('peak', 'smooth', 'full')


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def edit_ini(path, section, **options):
    """Set `options` in `section` of the ini at `path`."""
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read(path)
    config[section].update(options)
    with open(path, 'w') as fh:
        config.write(fh)


def with_components(main):
    edit_ini(main, 'output', write_pk='True', write_cf='True')
    return main


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield


@pytest.fixture(scope='module')
def auto(tmp_path_factory):
    """The tiny auto of tests/test_save_components.py, components on:
    both packages' interfaces after compute_model(run_init=False)."""
    main = with_components(make_synthetic_dataset(
        tmp_path_factory.mktemp('auto'), cross=False, size='tiny',
        noise=1.0))
    port, ref = VegaInterface(main, device='cpu'), JaxInterface(main)
    models = {'port': port.compute_model(run_init=False),
              'jax': ref.compute_model(run_init=False)}
    return {'port': port, 'jax': ref, 'models': models, 'main': main}


@pytest.fixture(scope='module')
def published_main(tmp_path_factory):
    """The tiny published DR16 configuration with the components written
    (vega_tpu's BuildConfig; fast_metals and fast_metal_bias off)."""
    return make_jax_dr16_published_dataset(
        tmp_path_factory.mktemp('published'), size='tiny', components=True)


@pytest.fixture(scope='module')
def published(published_main, tmp_path_factory):
    """published_main's LYA x LYA auto and LYA x QSO cross (the other two
    correlations repeat their structure with LYB), the metals at
    no-metal-decomp's default ('default') and decomposed ('decomposed'):
    both packages' interfaces after compute_model(run_init=False)."""
    names = ('lyaxlya', 'lyaxqso')
    mains = {
        'default': configuration_variant(
            published_main, tmp_path_factory.mktemp('default'), names),
        'decomposed': configuration_variant(
            published_main, tmp_path_factory.mktemp('decomposed'), names,
            model={'no-metal-decomp': 'False'})}
    out = {}
    for variant, main in mains.items():
        port, ref = VegaInterface(main, device='cpu'), JaxInterface(main)
        out[variant] = {'port': port, 'jax': ref,
                        'models': {'port': port.compute_model(
                                       run_init=False),
                                   'jax': ref.compute_model(
                                       run_init=False)}}
    return out


def held_to_jax(port, ref):
    """Every saved component of every model (and of its metals) has
    vega_tpu's keys and values; returns the worst value."""
    worst = 0.
    for name, model in port.models.items():
        pairs = [(model, ref.models[name])]
        if model.metals is not None:
            pairs.append((model.metals, ref.models[name].metals))
        for mine, theirs in pairs:
            for comp in COMPONENTS:
                for part in PARTS:
                    got = getattr(mine, comp)[part]
                    want = getattr(theirs, comp)[part]
                    assert set(got) == set(want), (name, comp, part)
                    for key in want:
                        worst = max(worst, max_rel(got[key], want[key]))
    return worst


def test_components_match_jax(auto):
    """The auto's saved components: vega_tpu's keys ('core' in peak and
    smooth, 'full' empty) and values within COMPONENT_RTOL; bao_amp x
    peak + smooth is the returned model."""
    port = auto['port']
    assert port.fiducial['save-components']
    assert held_to_jax(port, auto['jax']) <= COMPONENT_RTOL
    name = next(iter(port.corr_items))
    m = port.models[name]
    assert set(m.pk['peak']) == {'core'} and not m.pk['full']
    combined = (port.params['bao_amp'] * m.xi_distorted['peak']['core']
                + m.xi_distorted['smooth']['core'])
    assert max_rel(combined, auto['models']['port'][name]) <= SUM_RTOL


@pytest.mark.parametrize('variant', ['default', 'decomposed'])
def test_metal_components_match_jax(published, variant):
    """DR16 as published with five metals: at no-metal-decomp's default
    the models keep 'core' alone and the metals each pair's 'full'
    components; decomposed, each pair's peak and smooth components join
    the model's. Keys and values as vega_tpu's within COMPONENT_RTOL, the
    model equal to bao_amp x peak + smooth."""
    case = published[variant]
    port = case['port']
    assert held_to_jax(port, case['jax']) <= COMPONENT_RTOL
    for name, model in port.models.items():
        n_pairs = len(port.corr_items[name].metal_correlations)
        assert len(model.metals.xi['full']) == (
            n_pairs if variant == 'default' else 0)
        assert len(model.xi['peak']) == (
            1 if variant == 'default' else 1 + n_pairs)
        combined = (port.params['bao_amp'] * model.xi_distorted['peak']['core']
                    + model.xi_distorted['smooth']['core'])
        assert max_rel(combined, case['models']['port'][name]) <= SUM_RTOL


def test_stacking_guard_matches_jax(published, published_main, tmp_path):
    """With save-components the metals run unrolled in every evaluation,
    fit included, exactly where vega_tpu unrolls them
    (vega_tpu/metals.py:165); without it both stack them."""
    for name, model in published['default']['port'].models.items():
        assert model.metals._stacked_plans is None
        assert published['default']['jax'].models[name].metals \
            ._stacked_plans is None
    main = configuration_variant(published_main, tmp_path,
                                 output={'write_pk': 'False',
                                         'write_cf': 'False'})
    port, ref = VegaInterface(main, device='cpu'), JaxInterface(main)
    for name, model in port.models.items():
        assert model.metals._stacked_plans is not None
        assert ref.models[name].metals._stacked_plans is not None


def test_fast_metals_refuse_components_as_jax(published_main, tmp_path):
    """DR16 as published asks for fast_metals: with write_pk both
    packages raise the same ValueError at construction; fast_metals off
    but the metals' fast bias on (fast_metal_bias, on by default), both
    raise AssertionError at the first saved evaluation."""
    main = configuration_variant(published_main, tmp_path / 'fast',
                                 model={'fast_metals': 'True'})
    errors = []
    for build in (lambda: VegaInterface(main, device='cpu'),
                  lambda: JaxInterface(main)):
        with pytest.raises(ValueError, match='fast_metals mode') as info:
            build()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    main = configuration_variant(published_main, tmp_path / 'bias',
                                 model={'fast_metal_bias': 'True'})
    for vega in (VegaInterface(main, device='cpu'), JaxInterface(main)):
        with pytest.raises(AssertionError, match='fast_metal_bias=False'):
            vega.compute_model(run_init=False)


def test_components_saved_by_compute_model_alone(published):
    """chi2_batch, the value and gradient, the batched derivatives and a
    factored evaluation save nothing; only compute_model does."""
    port = published['default']['port']
    for model in port.models.values():
        for holder in (model, model.metals):
            for comp in COMPONENTS:
                for part in PARTS:
                    getattr(holder, comp)[part].clear()
    point = {'beta_LYA': 1.6, 'bias_eta_LYA': -0.2}
    port.chi2_batch({k: [v, v] for k, v in point.items()})
    port.chi2_value_and_gradient(point)
    port.chi2_batch_derivatives(list(point), [list(point.values())])
    for model in port.models.values():
        for holder in (model, model.metals):
            assert not any(getattr(holder, comp)[part]
                           for comp in COMPONENTS for part in PARTS)
    model = port.models['lyaxlya']
    with pytest.raises(ValueError, match='dense path'):
        model.compute(port.params, port._pk_full, port._pk_smooth,
                      sampling=Sampling(frozenset(point)), save=True)
    port.compute_model(point, run_init=False)
    assert set(model.xi['peak']) == {'core'}
    assert len(model.metals.pk['full']) == len(
        port.corr_items['lyaxlya'].metal_correlations)
    port.compute_model(run_init=False)      # the module's point again


def component_columns(path, reader):
    """{hdu name: {column: array}} of a results file's PK_ / Xi_ HDUs."""
    return {h.name: {c: np.asarray(h[c]) for c in h.columns}
            for h in reader(path)
            if getattr(h, 'name', '').startswith(('PK_', 'Xi_'))}


def write_both(case, tmp_path, stem, write_pk):
    """Each package's results file with its models' components; the
    PK_ HDUs only with write_pk. Returns {package: path}."""
    files = {}
    for package in ('port', 'jax'):
        vega = case[package]
        output = vega.output
        saved = output.output_pk
        output.output_pk = write_pk
        output.outfile = str(tmp_path / f'{package}_{stem}')
        try:
            output.write_results(case['models'][package], vega.params,
                                 models=vega.models)
        finally:
            output.output_pk = saved
        files[package] = output.outfile + '.fits'
    return files


def test_metal_component_hdus_read_by_either_package(published, tmp_path):
    """The Xi_ HDUs with the metals decomposed (a raw and a distorted
    column per metal pair and component): each package writes its results
    with the models; either package's FITS reader reads the same columns
    from both files, the values within COMPONENT_RTOL of each other."""
    files = write_both(published['decomposed'], tmp_path, 'xi', False)
    read = {(writer, reader_name): component_columns(path, reader)
            for writer, path in files.items()
            for reader_name, reader in (('port', read_fits),
                                        ('jax', jax_read_fits))}
    want = read[('jax', 'jax')]
    names = published['decomposed']['port'].corr_items
    assert set(want) == {f'Xi_{name}' for name in names}
    n_pairs = len(names['lyaxlya'].metal_correlations)
    assert len(want['Xi_lyaxlya']) == 4 * (1 + n_pairs)
    for key, columns in read.items():
        assert set(columns) == set(want)
        for hdu, cols in columns.items():
            assert set(cols) == set(want[hdu])
            for col, value in cols.items():
                if key[0] == 'jax':
                    assert np.array_equal(value, want[hdu][col])
                else:
                    assert max_rel(value, want[hdu][col]) <= COMPONENT_RTOL


def test_mixed_pk_grids_are_not_read_back_as_jax(published, tmp_path):
    """At size='tiny' the metals' P(k, mu_k) grids (1000 mu_k bins from
    [metals]) and the core's (50 from [model]) differ, and a PK_ table
    holding both cannot be read back by either package's FITS reader,
    whichever package wrote it (ROADMAP.md section 3)."""
    files = write_both(published['decomposed'], tmp_path, 'pk', True)
    for path in files.values():
        for reader in (read_fits, jax_read_fits):
            with pytest.raises(ValueError, match='Row size mismatch'):
                reader(path)


def test_run_init_rebuilds_models(auto):
    """compute_model(run_init=True) builds the models anew (a flag flipped
    since takes effect, vega_interface.py:1060-1071) and gives the same
    model; run_init=False keeps them."""
    port = auto['port']
    before = port.models
    again = port.compute_model(run_init=False)
    assert port.models is before
    rebuilt = port.compute_model(run_init=True)
    assert port.models is not before
    for name, value in auto['models']['port'].items():
        assert np.array_equal(again[name], value)
        assert max_rel(rebuilt[name], value) <= COMPONENT_RTOL
