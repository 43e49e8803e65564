"""The DR16-shaped model of the PyTorch port (metals through the spline +
Legendre combine, HCD, small-scale NL) against the JAX package (vega_tpu)
on the CPU, at size='tiny': the power-spectrum factors, the metal stack
(stacked, unrolled, factored; the options that change its algebra; a
metal distortion matrix), the coefficient program, and the slice as a
whole (chi2_batch, gradient, Hessian, nuisance collapse, grid chi^2).
The JAX side of the dataset is tests/tools/jax_metal_dataset.py. Each
tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
from vega_tpu import utils as jax_utils  # noqa: E402
from vega_tpu.io.fits import read_fits as jax_read_fits  # noqa: E402
from vega_tpu.io.fits import write_fits as jax_write_fits  # noqa: E402
from vega_tpu.ops.pallas_spline import (  # noqa: E402
    spline_legendre_combine_batched)
from vega_tpu.ops.spline import (  # noqa: E402
    notaknot_second_derivative_matrix)
from vega_tpu.power_spectrum import (  # noqa: E402
    PowerSpectrum as JaxPowerSpectrum)
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch import state  # noqa: E402
from vega_tpu_torch.factored import FactoredXi, Sampling  # noqa: E402
from vega_tpu_torch.ops import spline_combine as sc  # noqa: E402
from vega_tpu_torch.power_spectrum import PowerSpectrum  # noqa: E402
from vega_tpu_torch.testing import (DR16_METALS, DR16_PARAMETERS,  # noqa: E402
                                    dr16_extra_model)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

from test_torch_derivatives import stub_kernels  # noqa: E402, F401
from test_torch_host import jax_constants  # noqa: E402

CORRS = ('lyaxlya', 'qsoxlya')
FACTOR_RTOL = 1e-13     # one power-spectrum factor, f64 both sides
XI_RTOL = 1e-12         # a metal stack or a model, of its largest entry
CHI2_RTOL = 1e-10       # chi^2 (dense path, nuisance collapse)
DERIV_RTOL = 1e-9       # gradient and Hessian, of their largest entry
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
CONST_RTOL = 1e-14      # init-time constants
TWO_METALS = ('SiII(1260)', 'SiIII(1207)')
NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_hcd', 'beta_hcd',
         'bias_SiII(1260)', 'bias_SiIII(1207)')
NUISANCE = NAMES[2:]
POINTS = [
    {'ap': 1.03, 'at': 0.97, 'bias_LYA': -0.12, 'beta_LYA': 1.6,
     'bias_hcd': -0.05, 'beta_hcd': 0.7, 'bias_SiII(1260)': -0.0025,
     'bias_SiIII(1207)': -0.0035},
    {'ap': 0.9, 'at': 1.1, 'bias_LYA': -0.11, 'beta_LYA': 1.75,
     'bias_hcd': -0.06, 'beta_hcd': 0.55, 'bias_SiII(1260)': -0.0015,
     'bias_SiIII(1207)': -0.0045},
]
CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False'
TINY_GOLDENS = Path(__file__).resolve().parent / 'data' / \
    'torch_port_tiny_goldens.json'


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def add_metal_matrices(path):
    """Rewrite a metal file with a banded, row-normalised DM_<pair>
    column beside each pair's coordinates (a different band per pair)."""
    hdul = jax_read_fits(path)
    columns = {name: hdul[2][name] for name in hdul[2].columns}
    pairs = sorted(name[3:] for name in columns if name.startswith('RP_'))
    n = len(columns['RP_' + pairs[0]])
    for i, pair in enumerate(pairs):
        side = 0.02 + 0.01 * (i % 5)
        dm = (np.eye(n) * (1 - 2 * side) + np.eye(n, k=1) * side
              + np.eye(n, k=-1) * side)
        columns['DM_' + pair] = dm / dm.sum(axis=1, keepdims=True)
    jax_write_fits(path, [
        {'name': 'ATTRI', 'header': dict(hdul[1].header),
         'columns': {'DUMMY': np.zeros(1)}},
        {'name': 'MDMAT', 'columns': columns}])


# each variant: (metals, extra [model] lines, extra parameters, whether
# the metal files get DM_ columns)
VARIANTS = {
    'dr16': (DR16_METALS, '', {}, False),
    'decomp_single_beta': (
        TWO_METALS, 'no-metal-decomp = False\nsingle-metal-beta = True\n',
        {'beta_metals': 0.45}, False),
    'separate_biases_dmat': (
        TWO_METALS, 'separate-metal-auto-biases = True\n',
        {'bias_SiII(1260)_SiIII(1207)': 1.3}, True),
}


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
def variants(env, tmp_path_factory):
    """{variant: (vega_tpu interface, port interface on vega_tpu's host
    constants, main.ini)}, each on a tiny dataset made by vega_tpu."""
    out = {}
    for label, (metals, model, params, dmat) in VARIANTS.items():
        work = tmp_path_factory.mktemp(label)
        main = make_jax_metal_dataset(
            work, list(metals), cross=True, size='tiny',
            extra_control=CONTROL,
            extra_model=model + dr16_extra_model(
                parameters={**DR16_PARAMETERS, **params}))
        if dmat:
            for stem in ('cf_synthetic', 'xcf_synthetic'):
                add_metal_matrices(work / f'metal_{stem}.fits')
        jax_vega = JaxInterface(main)
        port = VegaInterface(main, device='cpu')
        own = state.export_constants(port)
        want = jax_constants(jax_vega)
        assert set(own) == set(want)
        for key, value in want.items():
            if value.dtype == bool:
                assert np.array_equal(own[key], value), key
            else:
                assert own[key].shape == value.shape, key
                assert np.max(np.abs(own[key] - value)) <= \
                    CONST_RTOL * np.max(np.abs(value)), key
        state.load_constants(port, want)
        out[label] = (jax_vega, port, main)
    return out


# ----------------------------------------------------------------------
# 1. Power-spectrum factors
# ----------------------------------------------------------------------
LYA = {'name': 'LYA', 'type': 'continuous'}
QSO = {'name': 'QSO', 'type': 'discrete'}
SI2 = {'name': 'SiII(1260)', 'type': 'continuous'}
PK_PARAMS = {'bias_LYA': -0.12, 'beta_LYA': 1.6, 'bias_QSO': 3.7,
             'beta_QSO': 0.26, 'bias_SiII(1260)': -0.002,
             'beta_SiII(1260)': 0.5, 'bias_hcd': -0.05, 'beta_hcd': 0.5,
             'L0_hcd': 10, 'L0_sinc': 10, 'L0_fvoigt': 1.2,
             'bias_hcd_LYAxQSO': -0.04,
             'dnl_arinyo_q1': 0.8558, 'dnl_arinyo_kv': 1.11454,
             'dnl_arinyo_av': 0.5378, 'dnl_arinyo_bv': 1.607,
             'dnl_arinyo_kp': 19.47, 'sigmaNL_par': 6.37,
             'sigmaNL_per': 3.24, 'sigma_velo_disp_lorentz_QSO': 6.86,
             'growth_rate': 0.97}


@pytest.fixture(scope='module')
def fiducial():
    hdul = jax_read_fits(jax_utils.find_file('PlanckDR16/PlanckDR16.fits'))
    return {'z_eff': 2.25, 'k': hdul[1]['K'], 'pk_full': hdul[1]['PK'],
            'pk_smooth': hdul[1]['PKSB'],
            'z_fiducial': hdul[1].header['ZREF']}


def model_config(**options):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['model'] = {'bin_size_rp': '4', 'bin_size_rt': '4', **options}
    return config['model']


def both_pk(fiducial, tracer1, tracer2, **options):
    name = 'lyaxlya'
    return (PowerSpectrum(model_config(**options), fiducial, tracer1,
                          tracer2, name, device='cpu'),
            JaxPowerSpectrum(model_config(**options), fiducial, tracer1,
                             tracer2, name))


# the reference's own regression checksums, as tests/test_pk.py:93-131
# holds vega_tpu to them (pytest.approx's default 1e-6 relative)
HCD_SUMS = {'Rogers': ({'model-hcd': 'Rogers'}, -116031.686,
                       1179867.64849),
            'fvoigt': ({'model-hcd': 'fvoigt', 'fvoigt_model': 'exp'},
                       -121782.768388, 1142662.6535),
            'sinc': ({'model-hcd': 'sinc'}, -118530.3944, 1166657.39777)}


@pytest.mark.parametrize('model', list(HCD_SUMS))
def test_hcd_models_match_reference_checksums(fiducial, model):
    options, bias_sum, beta_sum = HCD_SUMS[model]
    params = {'bias_hcd': -0.05, 'beta_hcd': 0.5, 'L0_hcd': 10,
              'L0_sinc': 10}
    pk, jax_pk = both_pk(fiducial, LYA, LYA, **options)
    bias_eff, beta_eff = pk.compute_bias_beta_hcd(-0.12, 1.6, params)
    assert float(bias_eff.sum()) == pytest.approx(bias_sum)
    assert float(beta_eff.sum()) == pytest.approx(beta_sum)
    want = jax_pk.compute_bias_beta_hcd(-0.12, 1.6, params)
    assert max_rel(bias_eff, want[0]) <= FACTOR_RTOL
    assert max_rel(beta_eff, want[1]) <= FACTOR_RTOL


def test_fast_metals_matches_reference_checksum(fiducial):
    pk, jax_pk = both_pk(fiducial, LYA, LYA)
    params = {'bias_LYA': -0.12, 'beta_LYA': 1.6, 'peak': False}
    got, bad = pk.compute(torch.as_tensor(fiducial['pk_smooth']), params,
                          fast_metals=True)
    assert float(got.mean()) == pytest.approx(1228.9847366)
    assert bad is False
    want, _ = jax_pk.compute(fiducial['pk_smooth'], params, fast_metals=True)
    assert max_rel(got, want) <= FACTOR_RTOL


FACTOR_CASES = {
    'arinyo_auto': (LYA, LYA, {'small scale nl': 'dnl_arinyo'}),
    'arinyo_cross': (QSO, LYA, {'small scale nl': 'dnl_arinyo',
                                'velocity dispersion': 'lorentz'}),
    'arinyo_metal': (SI2, SI2, {'small scale nl': 'dnl_arinyo'}),
    'mcdonald': (LYA, LYA, {'small scale nl': 'dnl_mcdonald'}),
    'rogers_cross': (LYA, QSO, {'model-hcd': 'Rogers2018',
                                'velocity dispersion': 'lorentz'}),
    'fvoigt_auto': (LYA, LYA, {'model-hcd': 'fvoigt',
                               'fvoigt_model': 'exp'}),
    'sinc_arinyo_auto': (LYA, LYA, {'model-hcd': 'sinc',
                                    'small scale nl': 'dnl_arinyo'}),
}


@pytest.mark.parametrize('case', list(FACTOR_CASES))
def test_power_spectrum_matches_jax(fiducial, case):
    """Every path through the ported factors: both components of
    compute_peak_smooth, the single-component compute (with and without
    the bias product), and a batch of two parameter rows against each
    row alone."""
    tracer1, tracer2, options = FACTOR_CASES[case]
    pk, jax_pk = both_pk(fiducial, tracer1, tracer2, num_bins_muk='96',
                         **options)
    pk_full = np.asarray(fiducial['pk_full'], float)
    pk_smooth = np.asarray(fiducial['pk_smooth'], float)
    t_full, t_smooth = torch.as_tensor(pk_full), torch.as_tensor(pk_smooth)
    params = dict(PK_PARAMS, peak=True)
    got = pk.compute_peak_smooth(params, t_full - t_smooth, t_smooth)
    want = jax_pk.compute_peak_smooth(params, pk_full - pk_smooth, pk_smooth)
    assert max_rel(got[0], want[0]) <= FACTOR_RTOL
    assert max_rel(got[1], want[1]) <= FACTOR_RTOL
    assert not bool(np.any(np.asarray(got[2]))) and not bool(want[2])
    for fast_metals in (False, True):
        one, _ = pk.compute(t_smooth, params, fast_metals=fast_metals)
        ref, _ = jax_pk.compute(pk_smooth, params, fast_metals=fast_metals)
        assert max_rel(one, ref) <= FACTOR_RTOL
    rows = [PK_PARAMS, dict(PK_PARAMS, bias_hcd=-0.07, beta_hcd=0.8,
                            beta_LYA=1.4, dnl_arinyo_q1=0.5, L0_hcd=7.0,
                            L0_fvoigt=0.9, L0_sinc=6.0)]
    varied = [k for k in rows[1] if rows[1][k] != rows[0][k]]
    batch = dict(params, **{k: torch.tensor([r[k] for r in rows],
                                            dtype=torch.float64)
                            for k in varied})
    batched = pk.compute_peak_smooth(batch, t_full - t_smooth, t_smooth)
    for b, row in enumerate(rows):
        alone = pk.compute_peak_smooth(dict(row, peak=True),
                                       t_full - t_smooth, t_smooth)
        for part in (0, 1):
            assert max_rel(batched[part][b], alone[part]) <= 1e-15


def test_arinyo_flags_a_row_that_is_not_finite(fiducial):
    pk, jax_pk = both_pk(fiducial, LYA, LYA,
                         **{'small scale nl': 'dnl_arinyo'})
    batch = dict(PK_PARAMS, dnl_arinyo_q1=torch.tensor(
        [0.8558, 1e308], dtype=torch.float64))
    _, bad = pk.compute_dnl_arinyo(batch)
    assert bad.tolist() == [False, True]
    _, jax_bad = jax_pk.compute_dnl_arinyo(dict(PK_PARAMS,
                                                dnl_arinyo_q1=1e308))
    assert bool(jax_bad)


# ----------------------------------------------------------------------
# 2. The metal stack
# ----------------------------------------------------------------------
def metal_pars(vega, overrides=None):
    return dict(vega.params, peak=False, **(overrides or {}))


METAL_POINT = {'bias_SiII(1260)': -0.003, 'beta_SiII(1260)': 0.6,
               'bias_SiIII(1207)': -0.005, 'bias_LYA': -0.12,
               'beta_LYA': 1.6, 'drp_QSO': 0.7,
               'sigma_velo_disp_lorentz_QSO': 5.5}
CASES = [(variant, corr) for variant in VARIANTS for corr in CORRS]


@pytest.mark.parametrize('variant,corr', CASES)
def test_metal_stack_matches_jax(variants, variant, corr):
    """Stacked and unrolled, each against vega_tpu's, and against each
    other (peak = False: the stacked path has no peak broadening)."""
    jax_vega, port, _ = variants[variant]
    metals, jax_metals = port.models[corr].metals, jax_vega.models[corr].metals
    assert [p['hashes'] for p in metals._stacked_plans] == \
        [p['hashes'] for p in jax_metals._stacked_plans]
    pk_full = jax_vega.fiducial['pk_full']
    want, want_bad = jax_metals.compute(metal_pars(jax_vega, METAL_POINT),
                                        pk_full, 'full')
    plans, jax_metals._stacked_plans = jax_metals._stacked_plans, None
    try:
        want_unrolled, _ = jax_metals.compute(
            metal_pars(jax_vega, METAL_POINT), pk_full, 'full')
    finally:
        jax_metals._stacked_plans = plans
    pars, _ = port._batch_params(METAL_POINT)
    pars['peak'] = False
    got, bad = metals.compute(pars, port._pk_full)
    unrolled, bad_u = metals.compute_unrolled(pars, port._pk_full)
    assert got.shape == unrolled.shape == (1,) + np.asarray(want).shape
    assert not bad.any() and not bad_u.any() and not bool(want_bad)
    assert max_rel(got[0], want) <= XI_RTOL
    assert max_rel(unrolled[0], want_unrolled) <= XI_RTOL
    assert max_rel(got, unrolled) <= XI_RTOL


@pytest.mark.parametrize('variant,corr', CASES)
def test_metal_stack_factored_equals_dense(variants, variant, corr):
    """With the metal biases sampled the stack stays factored (rows =
    pairs x 3 moments) and its dense view equals the dense branch; with
    a metal's alpha or (without the grid collapse) drp sampled it does
    not factor."""
    _, port, _ = variants[variant]
    metals = port.models[corr].metals
    pars, _ = port._batch_params(METAL_POINT)
    pars['peak'] = False
    dense, _ = metals.compute(pars, port._pk_full)
    sampled = frozenset(METAL_POINT) - {'drp_QSO',
                                       'sigma_velo_disp_lorentz_QSO'}
    factored, bad = metals.compute(pars, port._pk_full,
                                   sampling=Sampling(sampled))
    assert isinstance(factored, FactoredXi) and not bad.any()
    n_pairs = len(port.corr_items[corr].metal_correlations)
    # (a parameter given as a batch of one, here drp, leaves a leading 1)
    assert factored.V.shape[-2:] == (3 * n_pairs, dense.shape[-1])
    assert max_rel(factored.dense().reshape(dense.shape), dense) <= XI_RTOL
    assert factored.coeff_vector().reshape(-1).tolist() == [
        float(c) for c in metals.coefficients(pars)]
    for name in ('alpha_SiII(1260)',) + (('drp_QSO',) * (corr == 'qsoxlya')):
        out, _ = metals.compute(pars, port._pk_full,
                                sampling=Sampling(sampled | {name}))
        assert not isinstance(out, FactoredXi)
        assert max_rel(out, dense) <= XI_RTOL
    # drp as a grid name moves the cross's rows and stays factored
    if corr == 'qsoxlya':
        nodes = dict(pars, drp_QSO=torch.tensor([0.7, -0.4],
                                                dtype=torch.float64))
        out, _ = metals.compute(nodes, port._pk_full, sampling=Sampling(
            sampled | {'drp_QSO'}, frozenset({'drp_QSO'})))
        assert isinstance(out, FactoredXi)
        assert out.V.shape == (2, 3 * n_pairs, dense.shape[-1])
        assert max_rel(out.dense()[0], dense[0]) <= XI_RTOL


@pytest.mark.parametrize('corr', CORRS)
def test_metal_stack_rows_are_independent(variants, corr):
    """A batch of three rows, a sampled drp among them for the cross (a
    coordinate row per row), equals each row alone."""
    _, port, _ = variants['dr16']
    metals = port.models[corr].metals
    rows = [METAL_POINT,
            dict(METAL_POINT, **{'bias_SiII(1260)': -0.001, 'drp_QSO': -0.3,
                                 'beta_LYA': 1.8}),
            dict(METAL_POINT, **{'bias_SiIII(1207)': -0.002,
                                 'drp_QSO': 0.0})]
    batch, _ = port._batch_params(
        {k: [r[k] for r in rows] for k in METAL_POINT})
    batch['peak'] = False
    got, bad = metals.compute(batch, port._pk_full)
    assert got.shape[0] == 3 and not bad.any()
    for b, row in enumerate(rows):
        pars, _ = port._batch_params(row)
        pars['peak'] = False
        alone, _ = metals.compute(pars, port._pk_full)
        assert max_rel(got[b], alone[0]) <= 1e-14


def test_metal_matrices_are_applied(variants):
    """The DM_ columns of the metal file reach the model: the port reads
    vega_tpu's matrices, and with them the stack differs from the
    identity's."""
    jax_vega, port, _ = variants['separate_biases_dmat']
    for corr in CORRS:
        mats, jax_mats = port.data[corr].metal_mats, \
            jax_vega.data[corr].metal_mats
        assert list(mats) == list(jax_mats) and mats
        for pair, mat in mats.items():
            assert mat is not None and np.array_equal(mat, jax_mats[pair])
            assert not np.array_equal(mat, np.eye(len(mat)))
    _, plain, _ = variants['decomp_single_beta']
    assert all(m is None for m in plain.data['lyaxlya'].metal_mats.values())


# ----------------------------------------------------------------------
# 3. The model and its coefficient program
# ----------------------------------------------------------------------
@pytest.mark.parametrize('variant,corr', CASES)
def test_model_matches_jax(variants, variant, corr):
    """Model.compute (core + metals, both no-metal-decomp values) against
    vega_tpu's, at a point off the defaults."""
    jax_vega, port, _ = variants[variant]
    point = dict(POINTS[0], drp_QSO=0.4)
    want, want_bad = jax_vega.models[corr].compute(
        dict(jax_vega.params, **point), jax_vega.fiducial['pk_full'],
        jax_vega.fiducial['pk_smooth'])
    pars, _ = port._batch_params(point)
    got, bad = port.models[corr].compute(pars, port._pk_full,
                                         port._pk_smooth)
    assert not bad.any() and not bool(want_bad)
    assert max_rel(got[0], want) <= XI_RTOL


@pytest.mark.parametrize('variant,corr', CASES)
def test_coefficient_program_matches_factored_c0(variants, variant, corr):
    """Model.coefficients restates, term for term, the coefficient
    vector of the factored model (HCD-merged Kaiser terms of the peak
    and the smooth component, then the metals' per pair), and the
    factored model's dense view equals the dense model."""
    _, port, _ = variants[variant]
    model = port.models[corr]
    pars, _ = port._batch_params(POINTS[1])
    factored, _ = model.compute(pars, port._pk_full, port._pk_smooth,
                                sampling=Sampling(frozenset(NUISANCE)))
    assert isinstance(factored, FactoredXi)
    c0 = factored.coeff_vector().reshape(-1).numpy()
    got = model.coefficients(pars, 1)[0].numpy()
    n_pairs = len(port.corr_items[corr].metal_correlations)
    kaiser = 9 if corr == 'lyaxlya' else 6
    decomp = 1 if model.no_metal_decomp else 2
    assert got.shape == c0.shape == (2 * kaiser + decomp * 3 * n_pairs,)
    assert np.max(np.abs(got - c0)) <= 1e-12 * np.max(np.abs(c0))
    dense, _ = model.compute(pars, port._pk_full, port._pk_smooth)
    assert max_rel(factored.dense(), dense[0]) <= XI_RTOL


# ----------------------------------------------------------------------
# 4. The slice as a whole, on the tiny DR16-shaped configuration
# ----------------------------------------------------------------------
def draw_rows(n, seed):
    rng = np.random.default_rng(seed)
    truth = dict(zip(NAMES, (1.0, 1.0, -0.117, 1.67, -0.052, 0.65, -0.002,
                             -0.004)))
    return {name: val + 0.03 * abs(val) * rng.normal(size=n)
            for name, val in truth.items()}


@pytest.fixture(scope='module')
def dense_pair(variants, env):
    """(a fresh vega_tpu interface, the port) built with
    VEGA_TPU_FACTORED=0: vega_tpu reads the switch when it traces."""
    jax_vega, _, main = variants['dr16']
    env.setenv('VEGA_TPU_FACTORED', '0')
    port = VegaInterface(main, device='cpu')
    env.delenv('VEGA_TPU_FACTORED')
    state.load_constants(port, jax_constants(jax_vega))
    return JaxInterface(main), port


def test_dense_chi2_batch_matches_jax(dense_pair, monkeypatch):
    jax_vega, port = dense_pair
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    rows = draw_rows(5, 1)
    assert port.get_collapsed(NAMES) == {}
    got = port.chi2_batch(rows).numpy()
    want = np.asarray(jax_vega.chi2_batch(rows))
    assert np.all(got < 1e99)
    assert np.max(np.abs(got - want) / np.abs(want)) <= CHI2_RTOL


@pytest.mark.parametrize('regime', ['dense', 'nuisance', 'grid'])
def test_dr16_value_gradient_hessian_match_jax(variants, dense_pair,
                                               monkeypatch, regime):
    """chi^2, its gradient and Hessian over the sampled set: on the dense
    path (through the metals' combine and its backward), on the nuisance
    collapse (no ap, at) and on the port's own grid payload, which is
    held to vega_tpu's only within the mode budget (1e-6 relative here,
    as tests/test_torch_derivatives.py)."""
    jax_vega, port, _ = variants['dr16']
    tol = {'dense': DERIV_RTOL, 'nuisance': DERIV_RTOL, 'grid': 1e-6}[regime]
    point = dict(POINTS[0])
    if regime == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
        jax_vega, port = dense_pair
    elif regime == 'nuisance':
        point = {k: point[k] for k in NUISANCE}
    names = list(point)
    served = set(port.get_collapsed(names))
    assert served == {'dense': set(), 'nuisance': set(CORRS),
                      'grid': {'__grid__', *CORRS}}[regime]
    value, grad = port.chi2_value_and_gradient(point)
    hess = port.chi2_hessian(point, names)
    value_j, grad_j = jax_vega.chi2_value_and_gradient(point)
    hess_j = jax_vega.chi2_hessian(point, names)
    assert max_rel(value, value_j) <= tol
    assert max_rel([grad[n] for n in names],
                   [grad_j[n] for n in names]) <= tol
    assert max_rel([[hess[a][b] for b in names] for a in names],
                   [[hess_j[a][b] for b in names] for a in names]) <= tol


def test_nuisance_collapse_chi2_matches_jax(variants):
    jax_vega, port, _ = variants['dr16']
    rows = {k: v for k, v in draw_rows(6, 2).items() if k in NUISANCE}
    collapsed = port.get_collapsed(NUISANCE)
    assert {name: t['c0'].shape[0] for name, t in collapsed.items()} == \
        {'lyaxlya': 18 + 3 * 14, 'qsoxlya': 12 + 3 * 4}
    got = port.chi2_batch(rows).numpy()
    want = np.asarray(jax_vega.chi2_batch(rows))
    assert np.max(np.abs(got - want) / np.abs(want)) <= CHI2_RTOL


def test_grid_chi2_matches_jax_within_the_mode_budget(variants):
    """The grid regime with T = 60 / 24 terms: the port's payload from
    its own sweep (the metals' rows swept once, they do not move with
    ap, at) against vega_tpu's grid chi^2."""
    jax_vega, port, _ = variants['dr16']
    rows = draw_rows(16, 3)
    payload = port.get_collapsed(NAMES)
    jax_payload = jax_vega.get_collapsed(NAMES)
    for corr in CORRS:
        assert payload[corr]['cref'].shape == jax_payload[corr]['cref'].shape
        assert max_rel(payload[corr]['cref'], jax_payload[corr]['cref']) \
            <= 1e-12
    got = port.chi2_batch(rows).numpy()
    want = np.asarray(jax_vega.chi2_batch(rows))
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))


def test_batched_derivatives_group_the_metal_rows(dense_pair, stub_kernels):
    """Three rows under a gradient on the dense path with the kernel
    route taken (stub kernels): the metals' pair-major rows (row groups
    of the batch) go through the G = 1 Functions pair by pair, each
    pair's rows reading its coordinate row with stride 0; value,
    gradient and Hessian equal each row's own."""
    _, port = dense_pair
    names = list(NUISANCE)
    rows = draw_rows(3, 4)
    values = np.stack([rows[n] for n in names], axis=-1)
    with sc.recorded_launches() as layouts:
        chi2, grad, hess = port.chi2_batch_derivatives(names, values)
    metal_rows = {key for key in layouts
                  if key[0] == 'Ft' and key[2] == 3 and key[8]}
    assert metal_rows, sorted(layouts)
    for b in range(3):
        point = {n: float(rows[n][b]) for n in names}
        value, g = port.chi2_value_and_gradient(point, use_kernel=False)
        h = port.chi2_hessian(point, names, use_kernel=False)
        assert max_rel(float(chi2[b]), value) <= 1e-12
        assert max_rel(grad[b], [g[n] for n in names]) <= 1e-11
        assert max_rel(hess[b], [[h[a][c] for c in names] for a in names]) \
            <= 1e-10


def test_metal_paths_launch_the_kernel_at_their_layouts(variants, dense_pair,
                                                        stub_kernels):
    """With the kernel route taken (stub kernels) the metals launch F_0:
    on the dense path rows = pairs x batch with row groups of the batch
    for the auto (beta_LYA is sampled) and rows = pairs for the cross
    (only its weights are sampled, its knot tables are not batched); in
    the sweep rows = pairs x 3 with row groups of 3."""
    _, dense_port = dense_pair
    with sc.recorded_launches() as layouts:
        dense_port.chi2_batch(draw_rows(4, 5))
    n_q = {c: dense_port.data[c].full_data_size for c in CORRS}
    keys = {key[:2] + (key[2], key[5], key[6], key[7]) for key in layouts}
    assert ('F', 0, 14 * 4, 4, 14, n_q['lyaxlya']) in keys
    assert ('F', 0, 4, 1, 4, n_q['qsoxlya']) in keys
    _, port, main = variants['dr16']
    fresh = VegaInterface(main, device='cpu')
    with sc.recorded_launches() as layouts:
        fresh.get_collapsed(NAMES)
    keys = {key[:2] + (key[2], key[5], key[6], key[7]): rec.launches
            for key, rec in layouts.items()}
    # one launch per class for the whole sweep: the rows are kept
    assert keys[('F', 0, 3 * 14, 3, 14, n_q['lyaxlya'])] == 1
    assert keys[('F', 0, 3 * 4, 3, 4, n_q['qsoxlya'])] == 1


def test_plain_combine_matches_pallas_at_a_metal_layout():
    """The plain combine at the factored metal layout (rows = pairs x 3,
    one coordinate row per pair) against vega_tpu's Pallas kernel in
    interpret mode, which is f32: 1e-4 of the largest entry, as
    tests/test_pallas_spline.py holds it to XLA."""
    rng = np.random.default_rng(6)
    n_pairs, n_ell, n_knots, n_q = 4, 4, 64, 200
    knots = np.linspace(-1.0, 5.0, n_knots)
    y = rng.normal(size=(n_pairs * 3, n_ell, n_knots))
    m = np.einsum('ij,blj->bli', notaknot_second_derivative_matrix(knots), y)
    step = knots[1] - knots[0]
    cells = rng.integers(1, n_knots - 2, size=(n_pairs, n_q))
    x = knots[0] + (cells + rng.uniform(0.25, 0.75, (n_pairs, n_q))) * step
    leg = rng.uniform(-1, 1, (n_pairs, n_ell, n_q))
    grid = sc.KnotGrid.build(knots, 'cpu')
    got = sc.spline_legendre_combine(
        grid, torch.as_tensor(y), torch.as_tensor(m), torch.as_tensor(x),
        torch.as_tensor(leg), group=3).numpy()
    want = spline_legendre_combine_batched(
        knots, jnp.asarray(y, jnp.float32), jnp.asarray(m, jnp.float32),
        jnp.asarray(np.repeat(x, 3, axis=0), jnp.float32),
        jnp.asarray(np.repeat(leg, 3, axis=0), jnp.float32), interpret=True)
    assert max_rel(got, np.asarray(want)) <= 1e-4


# ----------------------------------------------------------------------
# 5. The reference's own model terms on this configuration, and what
#    still raises
# ----------------------------------------------------------------------
# the parameters the options read (vega_tpu/templates/
# parameter_defaults.ini; uv_shotnoise_amp away from its default of 0)
TERM_PARAMETERS = ('bias_gamma = 0.1125\nbias_gamma_e = 0.01\n'
                   'bias_prim = -0.66\nlambda_uv = 300.\n'
                   'lambda_HeII = 30.\nuv_shotnoise_amp = 0.001\n'
                   'Arel1 = -13.5\nArel3 = 1.\nAasy0 = 1.\nAasy2 = 1.\n'
                   'Aasy3 = 1.\n')


def with_option(main, tmp_path, corr, line, drop_metals=False):
    """A copy of `main` whose correlation `corr` carries `line` in its
    [model] section (and TERM_PARAMETERS in its [parameters]), without
    its [metals] section when asked."""
    source = Path(main).parent
    text = (source / f'{corr}.ini').read_text()
    text = text.replace('[model]\n', f'[model]\n{line}\n', 1)
    text = text.replace('[parameters]\n', '[parameters]\n' + TERM_PARAMETERS,
                        1)
    if drop_metals:
        start = text.index('[metals]')
        end = text.find('\n[', start + 1)
        text = text[:start] + ('' if end < 0 else text[end + 1:])
    (tmp_path / f'{corr}.ini').write_text(text)
    main_text = Path(main).read_text().replace(
        str(source / f'{corr}.ini'), str(tmp_path / f'{corr}.ini'))
    (tmp_path / 'main.ini').write_text(main_text)
    return tmp_path / 'main.ini'


# seven options of ROADMAP.md item 4c, each on the correlation that takes
# it (the relativistic and asymmetry terms are the cross's); fht_extrap on
# the auto without its metals, whose extrapolated multipoles diverge in
# the reference itself (tests/tools/variant_configs.py:436-446)
TERM_CASES = {
    'relativistic': ('qsoxlya', 'relativistic correction = True'),
    'uv_fluctuations': ('lyaxlya', 'UVB-fluctuations = True'),
    'heii': ('lyaxlya', 'HeII-reionization = True'),
    'asymmetry': ('qsoxlya', 'standard asymmetry = True'),
    'uv_shotnoise': ('lyaxlya', 'UVB-shotnoise = True'),
    'single_multipole': ('lyaxlya', 'single_multipole = 2'),
    'fht_extrap': ('lyaxlya', 'fht_extrap = True'),
}


@pytest.mark.parametrize('case', list(TERM_CASES))
def test_model_terms_match_jax(variants, tmp_path, monkeypatch, case):
    """Each option on top of the DR16-shaped configuration constructs,
    and the dense chi^2 of two rows agrees (CHI2_RTOL) with vega_tpu's
    on the same files (tests/data/torch_port_tiny_goldens.json,
    'dr16_terms', made by tests/tools/make_torch_port_tiny_goldens.py
    from this module's TERM_CASES, rows and configuration)."""
    _, _, main = variants['dr16']
    corr, line = TERM_CASES[case]
    main = with_option(main, tmp_path, corr, line,
                       drop_metals=case == 'fht_extrap')
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    golden = json.loads(TINY_GOLDENS.read_text())['dr16_terms']
    rows = {k: np.asarray(v) for k, v in golden['rows'].items()}
    got = VegaInterface(main, device='cpu').chi2_batch(rows).numpy()
    want = np.asarray(golden['chi2'][case])
    assert np.all(got < 1e99)
    assert np.max(np.abs(got - want) / np.abs(want)) <= CHI2_RTOL


# small-scale marginalization on the auto (the files have no distortion
# matrix: both packages take the identity, which carries the templates)
MARG_CASE = ('lyaxlya', 'marginalize-below-rtmax = 20.')


def test_unported_options_still_raise(variants, tmp_path, monkeypatch):
    """A config with [metals], model-hcd and small scale nl constructs;
    small-scale marginalization on top of it, which raised not_ported
    before it was ported, constructs too, and its dense chi^2 of two rows
    agrees (CHI2_RTOL) with vega_tpu's on the same files
    (tests/data/torch_port_tiny_goldens.json, 'dr16_terms', case
    'marginalization', made by tests/tools/make_torch_port_tiny_goldens.py
    from MARG_CASE)."""
    _, _, main = variants['dr16']
    main = with_option(main, tmp_path, *MARG_CASE)
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    golden = json.loads(TINY_GOLDENS.read_text())['dr16_terms']
    rows = {k: np.asarray(v) for k, v in golden['rows'].items()}
    vega = VegaInterface(main, device='cpu')
    assert vega.data['lyaxlya'].num_marg_modes > 0
    got = vega.chi2_batch(rows).numpy()
    want = np.asarray(golden['chi2']['marginalization'])
    assert np.all(got < 1e99)
    assert np.max(np.abs(got - want) / np.abs(want)) <= CHI2_RTOL
