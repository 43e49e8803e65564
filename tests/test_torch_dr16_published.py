"""eBOSS DR16 as published (examples/eBOSS_DR16/make_configs.py) in the
PyTorch port against the JAX package (vega_tpu) on the CPU: the legacy
Hamilton-2000 transform of old_fftlog (operators, knot grid, xi), the
growth factor of old_growth_func, the per-dataset `par / per binsize`
windows, the configuration's ini sections against vega_tpu's BuildConfig,
and the payload fingerprint, at size='tiny'
(tests/test_torch_dr16_published_fit.py holds the configuration as a
whole). The JAX side of the dataset is tests/tools/jax_dr16pub_dataset.py
(BuildConfig on make_configs.py's dictionaries). Each tolerance stands
beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_dr16pub_dataset import (build_dr16_published_inis,  # noqa: E402
                                 make_jax_dr16_published_dataset)
from vega_tpu.correlation_func import (  # noqa: E402
    CorrelationFunction as JaxCorrelationFunction)
from vega_tpu.pktoxi import _hamilton_operators  # noqa: E402
from vega_tpu.statics import resolve  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch import gridcollapse  # noqa: E402
from vega_tpu_torch.correlation_func import compute_growth_old  # noqa: E402
from vega_tpu_torch.models.eisenstein_hu import (  # noqa: E402
    make_fiducial_template)
from vega_tpu_torch.ops.spline_combine import KnotGrid  # noqa: E402
from vega_tpu_torch.pktoxi import hamilton_operators  # noqa: E402
from vega_tpu_torch.testing import (DR16PUB_CORRELATIONS,  # noqa: E402
                                    DR16PUB_SAMPLE,
                                    dr16_published_correlation,
                                    make_dr16_published_dataset)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

from test_torch_host import jax_read_fits, read_fits  # noqa: E402

OP_RTOL = 1e-12         # an operator or a xi, of its largest entry
GK_RTOL = 1e-14         # a binning window
XI_RTOL = 1e-12         # a model, of its largest entry
# a small node grid (6 x 6 x 4 x 4, one full tensor of 576 nodes): the
# tests hold the port's payload to vega_tpu's, not to the dense chi^2
CONTROL = {'grid-nodes-ap': '6', 'grid-nodes-at': '6',
           'grid-nodes-drp_QSO': '4',
           'grid-nodes-sigma_velo_disp_lorentz_QSO': '4',
           'ds-matmul': 'False'}


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def parse(path):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(path)
    return config


# ----------------------------------------------------------------------
# 1. old_fftlog, old_growth_func, binsize: the pieces
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def k_grids(tmp_path_factory):
    """The synthetic template's k grid at both sizes."""
    work = tmp_path_factory.mktemp('templates')
    return {n_k: make_fiducial_template(work / f'fid_{n_k}.fits',
                                        n_k=n_k)[0]
            for n_k in (128, 814)}


@pytest.mark.parametrize('n_k', [128, 814])
@pytest.mark.parametrize('n_exp,project', [(2, True), (2, False),
                                           (1, False)])
def test_legacy_operators_match_jax(k_grids, n_k, n_exp, project):
    """hamilton_operators against vega_tpu's _hamilton_operators: the
    knot grid log r - dr/2 bit for bit (uniform, so the combine kernel
    takes it), the operators to OP_RTOL, the last knot's row zero."""
    k = k_grids[n_k]
    ell_vals = (0, 2, 4, 6)
    ops, logr = hamilton_operators(k, ell_vals, n_exp, project)
    want_ops, want_logr = _hamilton_operators(k, ell_vals, n_exp, project)
    assert np.array_equal(logr, want_logr)
    assert ops.shape == want_ops.shape == (4, n_k, n_k)
    assert max_rel(ops, want_ops) <= OP_RTOL
    assert not ops[:, -1].any()
    assert KnotGrid.build(logr, 'cpu').step == pytest.approx(
        np.log(k.max() / k[0]) / n_k, rel=1e-12)


@pytest.fixture(scope='module')
def env():
    """The exact f64 payload contractions and no payload disk cache, for
    the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield mp


@pytest.fixture(scope='module')
def published(env, tmp_path_factory):
    """The tiny published configuration made by vega_tpu (BuildConfig) and
    by the port: {'jax', 'port' (main.ini paths), 'ref', 'vega' (the
    interfaces on vega_tpu's files, the route vega_tpu takes for the 18
    names), 'ref_dense', 'vega_dense' (built with VEGA_TPU_FACTORED=0)}."""
    jax_main = make_jax_dr16_published_dataset(
        tmp_path_factory.mktemp('dr16pub_jax'), size='tiny',
        extra_control=CONTROL)
    port_main = make_dr16_published_dataset(
        tmp_path_factory.mktemp('dr16pub_port'), size='tiny', device='cpu',
        extra_control=CONTROL)
    out = {'jax': jax_main, 'port': port_main,
           'ref': JaxInterface(jax_main),
           'vega': VegaInterface(jax_main, device='cpu')}
    env.setenv('VEGA_TPU_FACTORED', '0')
    out['ref_dense'] = JaxInterface(jax_main)
    out['vega_dense'] = VegaInterface(jax_main, device='cpu')
    env.delenv('VEGA_TPU_FACTORED')
    return out


@pytest.mark.parametrize('corr', DR16PUB_CORRELATIONS)
def test_legacy_grid_in_the_models(published, corr):
    """Each correlation's transform, and its metals', runs on the legacy
    knot grid with the legacy operators and spline operators of
    vega_tpu's (OP_RTOL)."""
    port = published['vega'].models[corr]
    ref = published['ref'].models[corr]
    assert np.array_equal(port.PktoXi.logr_knots, ref.PktoXi.logr_knots)
    assert port.PktoXi.old_fftlog
    for attr in ('fft_ops', 'fft_sd_ops'):
        assert max_rel(getattr(port.PktoXi, attr).numpy(),
                       resolve(getattr(ref.PktoXi, attr))) <= OP_RTOL
    for pair, pktoxi in port.metals.PktoXi.items():
        assert np.array_equal(pktoxi.logr_knots,
                              ref.metals.PktoXi[pair].logr_knots)


@pytest.mark.parametrize('corr', ['lyaxlya', 'lyaxqso'])
@pytest.mark.parametrize('ap', [1.0, 1.05])
def test_xi_under_old_fftlog_matches_jax(published, corr, ap):
    """The transform of a Kaiser-shaped P(k, mu_k) at AP-rescaled
    coordinates through the legacy operators and the combine against
    vega_tpu's (OP_RTOL), and the out-of-range flag against the legacy
    span: a coordinate beyond exp(last knot) is flagged by both."""
    port = published['vega'].models[corr]
    ref = published['ref'].models[corr]
    k = port.Pk_core.k_grid
    muk = port.Pk_core.muk_grid
    pk = published['vega'].fiducial['pk_full'] * (1 + 0.5 * muk ** 2) ** 2
    coords = published['vega'].corr_items[corr].model_coordinates
    rp = coords.r_grid * coords.mu_grid * ap
    rt = coords.r_grid * np.sqrt(1 - coords.mu_grid ** 2) / ap
    r = np.sqrt(rp ** 2 + rt ** 2)
    mu = rp / r
    got, oob = port.PktoXi.compute(torch.as_tensor(r), torch.as_tensor(mu),
                                   torch.as_tensor(pk))
    want, want_oob = ref.PktoXi.compute(jnp.asarray(r), jnp.asarray(mu),
                                        jnp.asarray(pk))
    assert max_rel(got[0].numpy(), want) <= OP_RTOL
    assert not bool(oob[0]) and not bool(want_oob)
    far = np.concatenate([r, [np.exp(port.PktoXi.logr_knots[-1]) * 1.01]])
    mu_far = np.concatenate([mu, [0.5]])
    _, oob = port.PktoXi.compute(torch.as_tensor(far),
                                 torch.as_tensor(mu_far), torch.as_tensor(pk))
    _, want_oob = ref.PktoXi.compute(jnp.asarray(far), jnp.asarray(mu_far),
                                     jnp.asarray(pk))
    assert bool(oob[0]) and bool(want_oob)
    assert len(k) == 128


@pytest.mark.parametrize('corr', DR16PUB_CORRELATIONS)
def test_growth_old_matches_jax_bit_for_bit(published, corr):
    """compute_growth_old (scipy quad on the host) against vega_tpu's,
    bit for bit, and each model's growth on its z grid; the metals keep
    the standard growth ([metals] does not set old_growth_func)."""
    vega, ref = published['vega'], published['ref']
    fid = vega.fiducial
    z = vega.corr_items[corr].model_coordinates.z_grid
    got = compute_growth_old(z, fid['z_fiducial'], fid['Omega_m'],
                             fid['Omega_de'])
    want = JaxCorrelationFunction.compute_growth_old(
        None, z, fid['z_fiducial'], fid['Omega_m'], fid['Omega_de'])
    assert np.array_equal(got, want)
    assert np.array_equal(vega.models[corr].Xi_core.xi_growth.numpy(),
                          np.asarray(ref.models[corr].Xi_core.xi_growth))
    for pair, xi in vega.models[corr].metals.Xi_metal.items():
        assert np.array_equal(
            xi.xi_growth.numpy(),
            np.asarray(ref.models[corr].metals.Xi_metal[pair].xi_growth))


@pytest.mark.parametrize('given', ['both', 'par', 'per', 'none'])
def test_binsize_window_matches_jax(published, given):
    """compute_Gk with the `par / per binsize <name>` parameters in place
    of the data's bin sizes (20 at size='tiny') against vega_tpu's; with
    neither it is the static window."""
    port = published['vega'].models['lyaxlya'].Pk_core
    ref = published['ref'].models['lyaxlya'].Pk_core
    params = {'par binsize lyaxlya': 3.0, 'per binsize lyaxlya': 5.0}
    params = {k: v for k, v in params.items()
              if given == 'both' or k.startswith(given)}
    got = port.compute_Gk(params).numpy()
    want = np.asarray(ref.compute_Gk(params))
    assert max_rel(got, want) <= GK_RTOL
    static = port.pk_Gk.numpy()
    if given == 'none':
        assert max_rel(got, static) <= GK_RTOL
    else:
        assert max_rel(got, static) > 1e-3


@pytest.mark.parametrize('binsize', [4.0, 12.0])
def test_binsize_moves_the_model_as_jax(published, binsize):
    """The model with `par / per binsize lyaxlya` at a value against
    vega_tpu's at the same value, and apart from the model at the data's
    bin size (20 at size='tiny'): the core's window takes the parameters
    (and the unrolled metals'), the stacked metals keep the static
    window as vega_tpu's stacked path does."""
    vega, ref = published['vega_dense'], published['ref_dense']
    point = {'par binsize lyaxlya': binsize, 'per binsize lyaxlya': binsize}
    got = vega.compute_model(point, run_init=False)['lyaxlya']
    want = ref.compute_model(point, run_init=False)['lyaxlya']
    assert max_rel(got, want) <= XI_RTOL
    data_bins = {'par binsize lyaxlya': 20., 'per binsize lyaxlya': 20.}
    assert max_rel(got, vega.compute_model(data_bins,
                                          run_init=False)['lyaxlya']) > 1e-4


def test_stacked_metals_keep_the_static_window_as_jax(published):
    """vega_tpu's stacked metal path reads no binsize parameter
    (vega_tpu/metals.py:456-457) where its unrolled path does
    (power_spectrum.py:496-505): the port's stacked and unrolled paths
    equal vega_tpu's stacked and unrolled paths, and differ from each
    other when the parameter is not the data's bin size (ROADMAP.md §3)."""
    vega, ref = published['vega_dense'], published['ref_dense']
    metals = vega.models['lyaxlya'].metals
    jax_metals = ref.models['lyaxlya'].metals
    pars = dict(vega.params, peak=False)
    jax_pars = dict(ref.params, peak=False)
    pk_full = ref.fiducial['pk_full']
    want, _ = jax_metals.compute(jax_pars, pk_full, 'full')
    plans, jax_metals._stacked_plans = jax_metals._stacked_plans, None
    try:
        want_unrolled, _ = jax_metals.compute(jax_pars, pk_full, 'full')
    finally:
        jax_metals._stacked_plans = plans
    got, _ = metals.compute(pars, vega._pk_full)
    unrolled, _ = metals.compute_unrolled(pars, vega._pk_full)
    assert max_rel(got[0], want) <= XI_RTOL
    assert max_rel(unrolled[0], want_unrolled) <= XI_RTOL
    assert max_rel(got, unrolled) > 1e-3


# ----------------------------------------------------------------------
# 2. The configuration's files
# ----------------------------------------------------------------------
@pytest.mark.parametrize('corr', DR16PUB_CORRELATIONS)
def test_full_size_sections_equal_build_config(tmp_path, corr):
    """At size='full' each correlation's ini equals the one vega_tpu's
    BuildConfig writes from make_configs.py's dictionaries, section for
    section; [model], [broadband], [parameters] above all."""
    main = build_dr16_published_inis(tmp_path, size='full')
    want = parse(tmp_path / f'{corr}.ini')
    got = dr16_published_correlation(corr, tmp_path / f'cf_{corr}.fits',
                                     tmp_path / f'metal_{corr}.fits')
    assert got.sections() == want.sections()
    for section in want.sections():
        assert dict(got[section]) == dict(want[section]), section
    assert ('broadband' in got) == (not corr.endswith('xqso'))
    assert dict(parse(main)['sample']) == DR16PUB_SAMPLE


def test_files_equal_jax(published):
    """The port's make_dr16_published_dataset writes vega_tpu's files: the
    main and correlation inis section for section ([model], [broadband],
    [parameters], [sample], [priors] and the rest; paths aside), the
    metal files and the template equal, the data vectors each package's
    own model (1e-12 of their largest entry)."""
    jax_dir, port_dir = published['jax'].parent, published['port'].parent
    for ini in ['main.ini'] + [f'{c}.ini' for c in DR16PUB_CORRELATIONS]:
        want, got = parse(jax_dir / ini), parse(port_dir / ini)
        assert got.sections() == want.sections()
        for section in want.sections():
            assert ({k: v.replace(str(port_dir), '@')
                     for k, v in got[section].items()}
                    == {k: v.replace(str(jax_dir), '@')
                        for k, v in want[section].items()}), (ini, section)
    fits = sorted(p.name for p in jax_dir.glob('*.fits'))
    assert fits == sorted(p.name for p in port_dir.glob('*.fits'))
    assert len(fits) == 9
    for name in fits:
        want, got = jax_read_fits(jax_dir / name), read_fits(port_dir / name)
        for hdu_w, hdu_g in zip(want[1:], got[1:]):
            assert dict(hdu_w.header) == dict(hdu_g.header)
            for col in hdu_w.columns:
                if col == 'DA':
                    assert max_rel(hdu_g[col], hdu_w[col]) <= 1e-12
                elif col == 'CO':
                    np.testing.assert_allclose(hdu_g[col], hdu_w[col],
                                               rtol=1e-11, atol=0)
                else:
                    assert np.array_equal(hdu_g[col], hdu_w[col])


def fingerprint(main):
    vega = VegaInterface(main, device='cpu')
    names = sorted(vega.sample_params['limits'])
    grid = vega._grid_candidate_names(frozenset(names))
    dims = [vega._grid_dim_setup(n) for n in grid]
    spec = gridcollapse.GridSpec(grid, *(tuple(d[i] for d in dims)
                                         for i in range(4)))
    return gridcollapse.payload_fingerprint(vega, names, spec, 2e-4, 1e-12)


@pytest.mark.parametrize('change', [
    ('lyaxlya.ini', 'bb1 = add pre rp,rt 0:0:1 0:0:1 broadband_sky',
     'bb1 = add post rp,rt 0:0:1 0:0:1 broadband_sky'),
    ('lyaxqso.ini', 'old_fftlog = True', 'old_fftlog = False'),
    ('lybxqso.ini', 'old_growth_func = True', 'old_growth_func = False'),
    ('lyaxlyb.ini', 'par binsize lyaxlyb = 4', 'par binsize lyaxlyb = 3'),
    ('lyaxlya.ini', '[broadband]\nbb1 = add pre rp,rt 0:0:1 0:0:1 '
     'broadband_sky\n', ''),
], ids=['broadband', 'old_fftlog', 'old_growth_func', 'binsize',
        'no_broadband'])
def test_fingerprint_moves_with_each_option(published, tmp_path, change):
    """The grid payload's content fingerprint changes when [broadband],
    old_fftlog, old_growth_func or a binsize parameter changes: a payload
    swept for one configuration never serves the other."""
    source = published['jax'].parent
    for path in source.glob('*'):
        if path.is_file():
            shutil.copy(path, tmp_path / path.name)
    main = tmp_path / 'main.ini'
    main.write_text(main.read_text().replace(str(source), str(tmp_path)))
    for ini in DR16PUB_CORRELATIONS:
        text = (tmp_path / f'{ini}.ini').read_text()
        (tmp_path / f'{ini}.ini').write_text(text.replace(str(source),
                                                          str(tmp_path)))
    before = fingerprint(main)
    name, old, new = change
    text = (tmp_path / name).read_text()
    assert old in text
    (tmp_path / name).write_text(text.replace(old, new))
    if name == 'lyaxlya.ini' and not new:
        # without the sky term its parameters leave [sample] too
        config = parse(main)
        for key in [k for k in config['sample'] if 'lyaxlya-0' in k]:
            del config['sample'][key]
        with open(main, 'w') as fh:
            config.write(fh)
    assert fingerprint(main) != before


def test_published_dataset_defaults_to_the_card(tmp_path):
    """Without a device, make_dr16_published_dataset runs on the card:
    with no CUDA device it raises before writing a file."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_dr16_published_dataset(tmp_path / 'out', size='tiny')
    assert not (tmp_path / 'out').exists()
