"""The f32 throughput mode of the PyTorch port (VegaInterface(..., dtype=
torch.float32) or VEGA_TPU_X64=0) on the eBOSS DR16 and DESI
configurations, on the CPU at size='tiny': synthetic-dr16 (Rogers HCD,
Arinyo NL, four Si metals from metal files), synthetic-desi (the DESI
DR1 baseline: new-metals matrices, QSO radiation, DESI instrumental
systematics, the joint covariance) and synthetic-dr16-published (four
correlations, old_fftlog, old_growth_func, binsize, the sky-residual
broadband, five metals), each written by the port's own dataset functions
(tests/tools/make_torch_port_f32_models_goldens.py's `make_tiny`).

vega_tpu's numbers on the same files, in f32 (VEGA_TPU_X64=0, in a
process of their own) and in f64, are committed in
tests/data/torch_port_f32_models_goldens.json ('tiny', made by that
tool). The ladder is vega_tpu's f32 one (tests/test_f32_mode.py:106-109;
tests/test_torch_f32_path.py): |d chi2| <= max(0.3, 3e-4 |chi2|). Held:

- the dense chi^2 against vega_tpu's f32, vega_tpu's f64 and the port's
  f64; the value and gradient at a point against vega_tpu's f32 and the
  port's f64;
- each ported term in f32 against the port's f64 on the same inputs:
  the stacked metals from metal files, the new-metals matrices, the HCD
  and Arinyo factors, the QSO radiation, the DESI instrumental
  systematics, old_fftlog's legacy transform, the sky-residual broadband
  and the joint quadratic form;
- the grid chi^2 on 8 x 8 (ap, at) nodes (dr16pub: vega_tpu's route,
  8 x 8 x 3 x 3) against vega_tpu's f32 and f64 grid and the port's f64,
  and dr16pub's route at the full configuration's nodes against
  vega_tpu's;
- a dense fit of synthetic-dr16 against the truth, within 1e-2 of the
  errors;
- no float64 tensor on the path (`F64Ops`).

The three configurations at full size run on the card (chip_smoke.py's
f32_models phase).
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from make_torch_port_f32_models_goldens import (CONFIGS,  # noqa: E402
                                                make_tiny, make_tiny_route)
from test_torch_f32_path import F64Ops  # noqa: E402
from vega_tpu_torch.vega_interface import (VegaInterface,  # noqa: E402
                                           quadratic_rows)

GOLDENS = Path(__file__).parent / 'data' / 'torch_port_f32_models_goldens.json'
LADDER_ABS, LADDER_REL = 0.3, 3e-4
# an f32 term against the f64 one on the same inputs, of max|f64| (the
# f32 kernels' gate against their f32 plain versions, chip_smoke.py)
TERM_RTOL = 1e-5
FIT_SIGMA = 1e-2


def within_ladder(got, want):
    """|d| <= max(LADDER_ABS, LADDER_REL |want|) entry by entry."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return bool(np.all(np.abs(got - want) <= np.maximum(
        LADDER_ABS, LADDER_REL * np.abs(want))))


def gradient_within(got, want):
    """Each entry within max(LADDER_ABS, LADDER_REL max|want|)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return bool(np.max(np.abs(got - want)) <= max(
        LADDER_ABS, LADDER_REL * np.max(np.abs(want))))


def max_rel(got, want):
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got)
    want = np.asarray(want.detach() if torch.is_tensor(want) else want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.delenv('VEGA_TPU_X64', raising=False)
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield mp


@pytest.fixture(scope='module')
def goldens():
    return json.loads(GOLDENS.read_text())['tiny']


@pytest.fixture(scope='module')
def port(env, tmp_path_factory):
    """port(config, regime, dtype): the port's interface on the tiny
    configuration, built once (dense: VEGA_TPU_FACTORED=0; grid: the
    defaults, on desi's main_grid.ini)."""
    work = tmp_path_factory.mktemp('f32_models')
    files, built = {}, {}

    def get(config, regime, dtype):
        if config not in files:
            files[config] = make_tiny(config, work / config)
        key = (config, regime, dtype)
        if key not in built:
            main, grid_main = files[config]
            if regime == 'dense':
                env.setenv('VEGA_TPU_FACTORED', '0')
            built[key] = VegaInterface(
                main if regime == 'dense' else grid_main, device='cpu',
                dtype=dtype)
            env.delenv('VEGA_TPU_FACTORED', raising=False)
        return built[key]
    return get


@pytest.mark.parametrize('config', CONFIGS)
def test_dense_chi2_matches_jax(port, goldens, config):
    """Dense chi^2 at 4 points within the ladder of vega_tpu's f32, its
    f64 and the port's f64 (measured on chi^2 of 51-255: 0.012, 0.0042,
    0.0057 from vega_tpu's f32; 0.0052, 0.0066, 0.0060 from the f64s)."""
    want = goldens[f'{config}/dense']
    got = port(config, 'dense', torch.float32).chi2_batch(want['points'])
    f64 = port(config, 'dense', torch.float64).chi2_batch(want['points'])
    assert got.dtype == torch.float32
    assert np.all(np.isfinite(got.numpy()))
    assert within_ladder(got.numpy(), want['f32']['chi2'])
    assert within_ladder(got.numpy(), want['f64']['chi2'])
    assert within_ladder(got.numpy(), f64.numpy())
    # the port's f64 is vega_tpu's f64
    np.testing.assert_allclose(f64.numpy(), want['f64']['chi2'], rtol=1e-8)


@pytest.mark.parametrize('config', CONFIGS)
def test_value_and_gradient_match(port, goldens, config):
    """chi2_value_and_gradient at one point: the value within the ladder
    and each gradient entry within max(0.3, 3e-4 max|gradient|) of
    vega_tpu's f32 and of the port's f64 (measured: values within 0.013,
    gradients 2.9e-6-6.6e-5 of max|gradient|)."""
    want = goldens[f'{config}/dense']
    value, grad = port(config, 'dense', torch.float32).chi2_value_and_gradient(
        want['point'])
    v64, g64 = port(config, 'dense', torch.float64).chi2_value_and_gradient(
        want['point'])
    names = list(want['point'])
    grad = [grad[n] for n in names]
    for v, g in ((want['f32']['value'], want['f32']['gradient']),
                 (v64, g64)):
        assert within_ladder([value], [v])
        assert gradient_within(grad, [g[n] for n in names])


def local_params(vega):
    """The configuration's values as the models read them, smooth
    component."""
    pars, _ = vega._batch_params(None)
    pars['peak'] = False
    return pars


def term_metal_stack(vega):
    """The stacked metals of the auto (legacy metal files)."""
    model = vega.models['lyaxlya']
    assert model.metals._stacked_plans is not None
    return model.metals.compute(local_params(vega), vega._pk_full)[0]


def term_new_metals(vega):
    """The cross's metals through the new-metals matrices."""
    model = vega.models['qsoxlya']
    assert model.metals.new_metals
    return model.metals.compute(local_params(vega), vega._pk_full)[0]


def term_hcd(vega):
    """Both components' P(k, mu_k) with the Rogers HCD and Arinyo NL."""
    model = vega.models['lyaxlya']
    peak, smooth, _ = model.Pk_core.compute_peak_smooth(
        local_params(vega), vega._pk_full - vega._pk_smooth,
        vega._pk_smooth)
    return torch.stack([peak, smooth])


def term_arinyo(vega):
    return vega.models['lyaxlya'].Pk_core.compute_dnl_arinyo(
        local_params(vega))[0]


def term_radiation(vega):
    xi = vega.models['qsoxlya'].Xi_core
    return xi.compute_qso_radiation(local_params(vega), xi._r, xi._mu)


def term_inst_sys(vega):
    coeff, template = vega.models['lyaxlya']._inst_sys_term(
        local_params(vega))
    return coeff * template


def term_old_fftlog(vega):
    """The legacy Hamilton transform of the auto's P(k, mu_k)."""
    model = vega.models['lyaxlya']
    assert model.PktoXi.old_fftlog
    pars = local_params(vega)
    pk = model.Pk_core.compute(vega._pk_full, pars)[0]
    return model.Xi_core.compute_core(pk, model.PktoXi, pars)[0]


def term_broadband(vega):
    """The sky residual of both autos."""
    pars = local_params(vega)
    return torch.stack([vega.models[name].broadband.compute(pars, 'pre-add')
                        for name in ('lyaxlya', 'lyaxlyb')])


def term_joint_form(vega):
    """The joint quadratic form of 4 seeded residual rows, cast to the
    interface's dtype."""
    if vega._chi2_data is None:
        vega.set_chi2_constants()
    rng = np.random.default_rng(1)
    joint = vega._chi2_data['_global']
    n = joint['inv_cov'].shape[0]
    diff = torch.as_tensor(rng.normal(size=(4, n)) * 0.01,
                           dtype=vega.dtype)
    return quadratic_rows(diff, joint['inv_cov'])


TERMS = {
    'metal_stack': ('dr16', term_metal_stack),
    'new_metals': ('desi', term_new_metals),
    'hcd': ('dr16', term_hcd),
    'arinyo': ('dr16', term_arinyo),
    'radiation': ('desi', term_radiation),
    'inst_sys': ('desi', term_inst_sys),
    'old_fftlog': ('dr16pub', term_old_fftlog),
    'broadband': ('dr16pub', term_broadband),
    'joint_form': ('desi', term_joint_form),
}


@pytest.mark.parametrize('term', TERMS)
def test_term_matches_f64(port, term):
    """Each term in f32 against the port's f64 on the same inputs,
    within TERM_RTOL of max|f64|, and f32 itself (measured 1.3e-8 (the
    systematics' template) to 3.7e-7 (the new-metals matrices))."""
    config, fn = TERMS[term]
    with torch.no_grad():
        got = fn(port(config, 'dense', torch.float32))
        want = fn(port(config, 'dense', torch.float64))
    assert got.dtype == torch.float32 and want.dtype == torch.float64
    assert got.shape == want.shape
    assert max_rel(got, want) <= TERM_RTOL


@pytest.mark.parametrize('config', CONFIGS)
def test_grid_chi2_matches(port, goldens, config):
    """The grid chi^2 (8 x 8 nodes; dr16pub: vega_tpu's route) within the
    ladder of vega_tpu's f32 and f64 grid and the port's f64 grid
    (measured: 0.0017, 0.0043, 0.012 from the f64s; from vega_tpu's f32
    0.18 on dr16, whose host-side data terms lose what the port's,
    centred on the device, keep)."""
    want = goldens[f'{config}/grid']
    got = port(config, 'grid', torch.float32).chi2_batch(want['points'])
    f64 = port(config, 'grid', torch.float64).chi2_batch(want['points'])
    assert got.dtype == torch.float32
    assert within_ladder(got.numpy(), want['f32']['chi2'])
    assert within_ladder(got.numpy(), want['f64']['chi2'])
    assert within_ladder(got.numpy(), f64.numpy())


def test_dr16pub_route_at_default_nodes(goldens, tmp_path):
    """vega_tpu's route for dr16pub's 18 names at the full configuration's
    payload spec (32 x 32 x 12 x 12 nodes): the port's f32 within the
    ladder of vega_tpu's f64 route, and no further from it than
    vega_tpu's own f32 route. On this 4-dimension payload the
    interpolated data term loses up to ~3e-4 of chi^2 in f32 (measured
    here on chi^2 of 51-240: the port 0.021, vega_tpu 0.19 from
    vega_tpu's f64; tests/tools/f32_route_error_parts.py; ROADMAP.md
    section 3)."""
    want = goldens['dr16pub/route_default_nodes']
    vega = VegaInterface(make_tiny_route(tmp_path), device='cpu',
                         dtype=torch.float32)
    got = vega.chi2_batch(want['points']).numpy()
    assert set(vega.get_collapsed(frozenset(want['points']))) == {
        '__grid__', 'lyaxqso', 'lybxqso'}
    assert within_ladder(got, want['f64']['chi2'])
    jax_gap = np.abs(np.asarray(want['f32']['chi2']) - want['f64']['chi2'])
    assert np.max(np.abs(got - want['f64']['chi2'])) <= np.max(jax_gap)


def test_fit_recovers_the_truth(port, goldens):
    """minimize() in f32 on synthetic-dr16's dense path from the [sample]
    start: valid, every best-fit value within 1e-2 of its error from the
    truth (the data are the model at the configuration's values)."""
    vega = port('dr16', 'dense', torch.float32)
    vega.minimize()
    best = vega.bestfit
    truth = {n: vega.params[n] for n in vega.sample_params['limits']}
    assert best.fmin.is_valid
    assert max(abs(best.values[n] - v) / best.errors[n]
               for n, v in truth.items()) <= FIT_SIGMA
    assert abs(best.fmin.fval) <= LADDER_ABS


@pytest.mark.parametrize('config', CONFIGS)
def test_no_f64_tensor_on_the_path(port, goldens, config):
    """chi2_batch on the dense and grid paths and the dense value and
    gradient of an f32 interface make no float64 tensor (each built and
    called once before)."""
    dense = port(config, 'dense', torch.float32)
    grid = port(config, 'grid', torch.float32)
    points = goldens[f'{config}/dense']['points']
    grid_points = goldens[f'{config}/grid']['points']
    dense.chi2_batch(points)
    grid.chi2_batch(grid_points)
    with F64Ops() as ops:
        dense.chi2_batch(points)
        grid.chi2_batch(grid_points)
        dense.chi2_value_and_gradient(goldens[f'{config}/dense']['point'])
    assert ops.seen == {}
