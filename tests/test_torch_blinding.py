"""Blinding in the PyTorch port against the JAX package's: the data-level
column of the BLINDING header (data.py), the hard stops of the interface
(`_init_blinding`), the parameter offsets (utils.get_blinding /
apply_blinding) and a forced offset on every path of the chi^2, dense and
on the grid route. The five cases of tests/test_blinding.py run on both
packages, on tiny synthetic files made by vega_tpu's
make_synthetic_dataset and rewritten by the port's
`testing.with_blinding`."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import shutil

import numpy as np
import pytest
import torch

import vega_tpu.utils as jax_utils
from vega_tpu.io.fits import read_fits
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import utils
from vega_tpu_torch.testing import with_blinding, with_control, with_sample
from vega_tpu_torch.vega_interface import VegaInterface

CHI2_RTOL = 1e-12           # dense chi^2, port vs vega_tpu
GRID_ABS, GRID_REL = 2e-4, 1e-9     # the grid route, vega_tpu's budget
BATCH = {'bias_LYA': np.array([-0.11, -0.117, -0.125]),
         'beta_LYA': np.array([1.6, 1.67, 1.75])}
# an offset pi - exp(v^2) of -5.3e-4 on ap, inside the node domain
AP_BLINDING = 1.07


@pytest.fixture(scope='module')
def base(tmp_path_factory):
    """A tiny auto+cross dataset with noise (vega_tpu's files)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        work = tmp_path_factory.mktemp('base')
        jax_make_dataset(work, cross=True, size='tiny', noise=1.0)
        yield work


@pytest.fixture
def dense_env(monkeypatch):
    """Both packages on the dense path (vega_tpu reads the switch when it
    traces, the port at construction)."""
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')


def variant(base, tmp_path, auto=None, cross=None, seed=0):
    """A copy of the base dataset in `tmp_path` with the auto's and the
    cross's BLINDING set (None: the file as written), each with a seeded
    DA_BLIND column. Returns the copy's main.ini."""
    work = tmp_path / 'data'
    shutil.copytree(base, work)
    for ini in work.glob('*.ini'):
        ini.write_text(ini.read_text().replace(str(base), str(work)))
    for stem, strategy, offset in (('cf_synthetic', auto, 0),
                                   ('xcf_synthetic', cross, 1)):
        if strategy is not None:
            with_blinding(work / f'{stem}.fits', strategy, seed=seed + offset)
    return work / 'main.ini'


def both(main, error=None, match=None):
    """(vega_tpu's interface, the port's), or with `error` both raising
    it (matching `match`)."""
    if error is not None:
        with pytest.raises(error, match=match):
            JaxInterface(main)
        with pytest.raises(error, match=match):
            VegaInterface(main, device='cpu')
        return None
    return JaxInterface(main), VegaInterface(main, device='cpu')


def rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                        / np.abs(np.asarray(want))))


@pytest.mark.parametrize('strategy', ['desi_m2', 'desi_y1', 'desi_y3'])
def test_passthrough_strategies(base, tmp_path, dense_env, strategy):
    """desi_m2 / y1 / y3 read DA and leave `blind` False in both packages
    (vega_tpu/data.py:222-227); the chi^2 is the unblinded one (1e-12
    relative)."""
    jax_vega, port = both(variant(base, tmp_path, strategy, strategy))
    for vega in (jax_vega, port):
        data = vega.data['lyaxlya']
        assert data.blinding_strat == strategy and data.blind is False
        assert vega._blind is False and vega._rnsps is None
    raw = read_fits(tmp_path / 'data' / 'cf_synthetic.fits')[1]
    assert np.array_equal(port.data['lyaxlya'].data_vec, raw['DA'])
    assert rel(port.chi2_batch(BATCH).numpy(),
               jax_vega.chi2_batch(BATCH)) <= CHI2_RTOL


def test_desi_dr3_requires_blind_column(base, tmp_path):
    main = variant(base, tmp_path)
    with_blinding(tmp_path / 'data' / 'cf_synthetic.fits', 'desi_dr3',
                  blind_column=False)
    both(main, AssertionError, 'do not run')


def test_desi_dr3_uses_blind_column(base, tmp_path, dense_env):
    """desi_dr3 reads DA_BLIND bit for bit in both packages, and the
    chi^2 on it equals vega_tpu's (1e-12 relative) and moves from the
    unblinded one."""
    jax_vega, port = both(variant(base, tmp_path, 'desi_dr3', 'desi_dr3'))
    for name, stem in (('lyaxlya', 'cf'), ('qsoxlya', 'xcf')):
        raw = read_fits(tmp_path / 'data' / f'{stem}_synthetic.fits')[1]
        assert port.data[name].blind is True
        assert np.array_equal(port.data[name].data_vec, raw['DA_BLIND'])
        assert np.array_equal(jax_vega.data[name].data_vec,
                              port.data[name].data_vec)
    assert port._blind and port._rnsps is None
    got = port.chi2_batch(BATCH).numpy()
    assert rel(got, jax_vega.chi2_batch(BATCH)) <= CHI2_RTOL
    unblinded = VegaInterface(base / 'main.ini', device='cpu')
    assert np.all(np.abs(got - unblinded.chi2_batch(BATCH).numpy()) > 1.0)


def test_blind_fixed_parameter_rejected(base, tmp_path):
    """A sampled BLIND_FIXED_PARS name on blinded data stops both
    (vega_tpu/vega_interface.py:1807-1810)."""
    main = variant(base, tmp_path, 'desi_dr3', 'desi_dr3')
    main = with_sample(main, {'bias_LYA': 'True',
                              'ap_full': '0.5 1.5 1.0 0.1'}, main)
    main.write_text(main.read_text().replace('[parameters]\n',
                                             '[parameters]\nap_full = 1.0\n'))
    both(main, ValueError, 'must be fixed')


def test_unknown_strategy_rejected(base, tmp_path):
    both(variant(base, tmp_path, 'desi_y9'), ValueError, 'Unknown blinding')


def test_bias_and_beta_qso_rejected(base, tmp_path):
    """bias_QSO and beta_QSO sampled together on blinded data stop both
    (vega_tpu/vega_interface.py:1822-1826)."""
    main = variant(base, tmp_path, 'desi_dr3', 'desi_dr3')
    main = with_sample(main, {'bias_QSO': 'True', 'beta_QSO': 'True'}, main)
    both(main, ValueError, 'bias_QSO and beta_QSO')


def test_mixed_strategies(base, tmp_path, dense_env):
    """desi_dr3 on the auto beside desi_y1 on the cross: both packages
    blind (one blinded data set makes the fit blind), the auto on
    DA_BLIND, the cross on DA, the same chi^2 (1e-12 relative)."""
    jax_vega, port = both(variant(base, tmp_path, 'desi_dr3', 'desi_y1'))
    for vega in (jax_vega, port):
        assert vega._blind is True
        assert vega.data['lyaxlya'].blind is True
        assert vega.data['qsoxlya'].blind is False
    assert rel(port.chi2_batch(BATCH).numpy(),
               jax_vega.chi2_batch(BATCH)) <= CHI2_RTOL


def test_growth_rate_sampled_under_desi_dr3(base, tmp_path):
    """growth_rate is a blinded name: under desi_dr3 its offsets are
    asked of get_blinding, which knows no desi_dr3 file and raises in
    both packages (vega_tpu/utils.py:313-314)."""
    main = variant(base, tmp_path, 'desi_dr3', 'desi_dr3')
    main = with_sample(main, {'bias_LYA': 'True',
                              'growth_rate': '0.5 1.5 0.97 0.05'}, main)
    main = with_control(main, 'use_template_growth_rate = False', main)
    both(main, ValueError, 'Unknown blinding version')


def test_apply_and_get_blinding_match_jax():
    """get_blinding and apply_blinding against vega_tpu's: the same
    returns and raises, and the offsets bit for bit on floats and, row by
    row, on (B,) tensors."""
    for pars, strat in ((['growth_rate'], 'desi_y1'), (['ap'], 'desi_y3'),
                        (['phi_smooth'], 'desi_y3')):
        assert utils.get_blinding(pars, strat) is None
        assert jax_utils.get_blinding(pars, strat) is None
    for pars, strat, match in ((['growth_rate'], 'desi_dr3', 'version'),
                               (['bias_LYA'], 'desi_y1', 'No blinding')):
        for get in (utils.get_blinding, jax_utils.get_blinding):
            with pytest.raises(ValueError, match=match):
                get(pars, strat)
    for get in (utils.get_blinding, jax_utils.get_blinding):
        with pytest.raises(AssertionError, match='do not run'):
            get(['ap'], None)
    assert utils.BLIND_FIXED_PARS == jax_utils.BLIND_FIXED_PARS
    assert utils.VEGA_BLINDED_PARS == jax_utils.VEGA_BLINDED_PARS

    blinding = {'growth_rate': 0.3, 'phi_smooth': -1.2, 'ap': AP_BLINDING}
    params = {'growth_rate': 0.97, 'phi_smooth': 1.0, 'ap': 1.01, 'at': 0.9}
    got = utils.apply_blinding(dict(params), blinding)
    want = jax_utils.apply_blinding(dict(params), blinding)
    assert got == want
    rows = {k: torch.tensor([v, v + 0.1], dtype=torch.float64)
            for k, v in params.items()}
    batched = utils.apply_blinding(rows, blinding)
    for k in params:
        row = jax_utils.apply_blinding(
            {n: v + 0.1 for n, v in params.items()}, blinding)[k]
        assert batched[k][0].item() == want[k]
        assert batched[k][1].item() == row


@pytest.fixture(scope='module')
def grid_base(tmp_path_factory):
    """A tiny dataset with (ap, at) on 8 x 8 nodes and the JAX package's
    exact payload contractions."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        work = tmp_path_factory.mktemp('grid_base')
        yield jax_make_dataset(
            work, cross=True, size='tiny', noise=1.0,
            sample={'ap': 'True', 'at': 'True', 'bias_LYA': 'True',
                    'beta_LYA': 'True'},
            extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n'
                          'ds-matmul = False')


@pytest.mark.parametrize('route', ['dense', 'grid'])
def test_forced_offsets_match_jax(grid_base, monkeypatch, route):
    """With offsets forced on both interfaces (`_rnsps`, as a blinding
    file would give them: bias_LYA and ap), the chi^2 on blinded DA_BLIND
    data against vega_tpu's: dense (1e-12 relative) and on the grid
    route, whose nodes are sampled values blinded in the sweep (vega_tpu's
    mode budget: 2e-4 + 1e-9 |chi2|); it moves from the chi^2 without
    offsets."""
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE', '0')
    monkeypatch.setenv('VEGA_TPU_DS_MATMUL', '0')
    if route == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    else:
        monkeypatch.delenv('VEGA_TPU_FACTORED', raising=False)
        monkeypatch.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
    work = grid_base.parent
    for stem, seed in (('cf_synthetic', 5), ('xcf_synthetic', 6)):
        with_blinding(work / f'{stem}.fits', 'desi_dr3', seed=seed)
    jax_vega, port = both(grid_base)
    rng = np.random.default_rng(2)
    batch = {'ap': rng.uniform(0.9, 1.1, 6), 'at': rng.uniform(0.9, 1.1, 6),
             'bias_LYA': -0.117 * (1 + 0.05 * rng.normal(size=6)),
             'beta_LYA': 1.67 * (1 + 0.05 * rng.normal(size=6))}
    plain = port.chi2_batch(batch).numpy()
    blinding = {'bias_LYA': 1.08, 'ap': AP_BLINDING}
    jax_vega._rnsps = dict(blinding)
    port._rnsps = dict(blinding)
    port._collapsed_cache, port._grid_cache = {}, {}
    got = port.chi2_batch(batch).numpy()
    want = np.asarray(jax_vega.chi2_batch(batch))
    if route == 'dense':
        assert rel(got, want) <= CHI2_RTOL
        assert rel(port.chi2(), jax_vega.chi2()) <= CHI2_RTOL
    else:
        assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))
        assert port.get_collapsed(frozenset(batch)).get('__grid__') is not None
    assert np.all(np.abs(got - plain) > 1.0)
