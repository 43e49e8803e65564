"""Grid payloads of three and four dimensions in the PyTorch port
(vega_tpu_torch.gridcollapse with VegaInterface.get_collapsed) against the
JAX package's (vega_tpu), on the CPU at size='tiny': the combination
schedule (plan_components, component_nodes) for 2-5 dimensions, and the
payloads of (ap, at, drp_QSO) and (ap, at, drp_QSO,
sigma_velo_disp_lorentz_QSO) swept through it (grid-combination = always,
8 / 8 / 4 / 4 nodes) on the plain and the DR16-shaped cross
configuration (6 / 6 / 4 / 4 nodes there): components, T, kept modes,
ranks, tensors, held-out probe errors and the served chi^2; the served
chi^2 against vega_tpu's dense chi^2 on narrowed domains; and the node
limit's dense fallback. Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

import vega_tpu.gridcollapse as jgc  # noqa: E402
from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
from vega_tpu.testing import make_synthetic_dataset  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch import gridcollapse as gc  # noqa: E402
from vega_tpu_torch.testing import DR16_METALS, dr16_extra_model  # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

CORRS = ('lyaxlya', 'qsoxlya')
TENSOR_ATOL = 1e-10     # cref, B_A F_A, B_sy F_sy: of max |vega_tpu's|
PROBE_RTOL = 1e-8       # probe_err, relative
GRID_ABS, GRID_REL = 1e-8, 1e-10    # served chi^2 vs vega_tpu's
CHI2_RTOL = 1e-10       # the dense fallback's chi^2, relative
# vega_tpu's own bound of a combination payload against its dense chi^2
# on narrowed domains (tests/test_grid_combination.py:204)
DENSE_RTOL, DENSE_ATOL = 1e-3, 0.2

NODES = ('grid-nodes-drp_QSO = 4\n'
         'grid-nodes-sigma_velo_disp_lorentz_QSO = 4\n'
         'grid-combination = always\nds-matmul = False\n')
AP_AT_NODES = {'plain': 8, 'dr16': 6}
QSO = {'drp_QSO': '-3.0 3.0 0.0 0.1',
       'sigma_velo_disp_lorentz_QSO': '0.0 15.0 6.86 0.1'}
LINEAR = {'bias_LYA': '-1.0 0.0 -0.117 0.01', 'beta_LYA': '0.0 3.0 1.67 0.1'}
DR16 = {'bias_hcd': '-0.5 0.0 -0.052 0.01',
        'bias_SiII(1260)': '-0.5 0.0 -0.002 0.001'}
CASES = ('plain-3', 'plain-4', 'dr16-3', 'dr16-4')


def sample_of(case):
    kind, dims = case.split('-')
    sample = {'ap': '0.5 1.5 1.0 0.01', 'at': '0.5 1.5 1.0 0.01',
              **LINEAR, 'drp_QSO': QSO['drp_QSO']}
    if dims == '4':
        sample['sigma_velo_disp_lorentz_QSO'] = \
            QSO['sigma_velo_disp_lorentz_QSO']
    if kind == 'dr16':
        sample.update(DR16)
    return sample


def points(sample, n=8, seed=3):
    """n points inside the node domain, every sampled name varied."""
    rng = np.random.default_rng(seed)
    out = {'ap': rng.uniform(0.8, 1.2, n), 'at': rng.uniform(0.8, 1.2, n),
           'drp_QSO': rng.uniform(-2.5, 2.5, n),
           'sigma_velo_disp_lorentz_QSO': rng.uniform(1.0, 14.0, n)}
    for name, entry in sample.items():
        if name not in out:
            value = float(entry.split()[2])
            out[name] = value * (1 + 0.05 * rng.normal(size=n))
    return {k: v for k, v in out.items() if k in sample}


@pytest.fixture(scope='module', autouse=True)
def env():
    """vega_tpu's exact f64 payload contractions, no payload disk cache
    in either package, the defaults of both dispatch switches."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        mp.delenv('VEGA_TPU_GRID_MAX_NODES', raising=False)
        yield


class Built:
    """One case's files, interfaces and payloads."""

    def __init__(self, workdir, case):
        self.sample = sample_of(case)
        self.names = tuple(sorted(self.sample))
        n = AP_AT_NODES[case.split('-')[0]]
        control = f'grid-nodes-ap = {n}\ngrid-nodes-at = {n}\n' + NODES
        if case.startswith('dr16'):
            self.main = make_jax_metal_dataset(
                workdir, list(DR16_METALS), cross=True, size='tiny',
                sample=self.sample, extra_control=control,
                extra_model=dr16_extra_model())
        else:
            self.main = make_synthetic_dataset(
                workdir, cross=True, size='tiny', sample=self.sample,
                extra_control=control)
        self.jax = JaxInterface(self.main)
        self.port = VegaInterface(self.main, device='cpu')
        self.jax_payload = self.jax.get_collapsed(self.names)
        self.port_payload = self.port.get_collapsed(frozenset(self.names))


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = Built(tmp_path_factory.mktemp(case), case)
        return cache[case]
    return get


# ----------------------------------------------------------------------
# The combination schedule
# ----------------------------------------------------------------------
DEGREES = {2: (32, 32), 3: (32, 32, 12), 4: (32, 32, 12, 12),
           5: (16, 16, 8, 6, 4)}


@pytest.mark.parametrize('mode', ['auto', 'always', 'never'])
@pytest.mark.parametrize('dims', [2, 3, 4, 5])
def test_plan_and_nodes_equal_jax(dims, mode):
    """plan_components at interaction orders 2-4 and two tensor budgets,
    and every component's nodes, equal to vega_tpu's (exact)."""
    degrees = DEGREES[dims]
    args = ([f'p{i}' for i in range(dims)], [0.5 - i for i in range(dims)],
            [1.5 + i for i in range(dims)], degrees, [1.0] * dims)
    spec, jspec = gc.GridSpec(*args), jgc.GridSpec(*args)
    for order in (2, 3, 4):
        for max_tensor in (None, 64):
            got = gc.plan_components(spec, mode=mode, order=order,
                                     max_tensor=max_tensor)
            want = jgc.plan_components(jspec, mode=mode, order=order,
                                       max_tensor=max_tensor)
            assert repr(got) == repr(want)
    for degs, _ in gc.plan_components(spec, mode=mode):
        if np.prod(degs) <= 50_000:
            assert np.array_equal(gc.component_nodes(spec, degs),
                                  jgc.component_nodes(jspec, degs))


# ----------------------------------------------------------------------
# Three- and four-dimension payloads
# ----------------------------------------------------------------------
@pytest.mark.parametrize('case', CASES)
def test_payload_structure_equals_jax(built, case):
    """The spec, the components, and per correlation T, the kept modes
    of both blocks and their SVD ranks: equal."""
    b = built(case)
    spec, jspec = b.port_payload['__grid__'], b.jax_payload['__grid__']
    dims = int(case[-1])
    assert len(spec.names) == dims
    assert (spec.names, spec.lo, spec.hi, spec.degrees, spec.ref) == (
        jspec.names, jspec.lo, jspec.hi, jspec.degrees, jspec.ref)
    components = gc.plan_components(spec, mode='always')
    assert len(components) > 1
    assert repr(components) == repr(jgc.plan_components(jspec,
                                                        mode='always'))
    assert b.port.grid_stats['nodes'] == 8 + sum(
        int(np.prod(d)) for d, _ in components)
    for name in CORRS:
        got, want = b.port_payload[name], b.jax_payload[name]
        assert got['cref'].shape == want['cref'].shape
        for block in ('A', 'sy'):
            assert np.array_equal(got[f'modes_{block}'],
                                  want[f'modes_{block}'])
            assert got[f'B_{block}'].shape == want[f'B_{block}'].shape


@pytest.mark.parametrize('case', CASES)
def test_payload_tensors_match_jax(built, case):
    """cref and the products B_A F_A, B_sy F_sy (an SVD fixes its factors
    only up to sign) within TENSOR_ATOL of max |vega_tpu's|; dc_max and
    the held-out probe error within PROBE_RTOL."""
    b = built(case)
    for name in CORRS:
        got, want = b.port_payload[name], b.jax_payload[name]
        pairs = [(got['cref'], want['cref'])] + [
            (got[f'B_{k}'] @ got[f'F_{k}'], want[f'B_{k}'] @ want[f'F_{k}'])
            for k in ('A', 'sy')]
        for g, w in pairs:
            assert np.max(np.abs(g - w)) <= TENSOR_ATOL * np.max(np.abs(w))
        for key in ('dc_max', 'probe_err'):
            w = float(want[key])
            assert w > 0
            assert abs(float(got[key]) - w) <= PROBE_RTOL * w


@pytest.mark.parametrize('case', CASES)
def test_grid_chi2_matches_jax(built, case):
    """The served chi^2 at 8 points with every sampled name varied:
    within GRID_ABS + GRID_REL |chi2| of vega_tpu's grid chi^2."""
    b = built(case)
    batch = points(b.sample)
    want = np.asarray(b.jax.chi2_batch(batch))
    got = b.port.chi2_batch(batch).numpy()
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))


def test_combination_payload_tracks_jax_dense(tmp_path, monkeypatch):
    """(ap, at, drp_QSO) through the combination schedule on narrowed
    domains (vega_tpu's own end-to-end case): the port's served chi^2
    within vega_tpu's bound of vega_tpu's dense chi^2."""
    sample = {'ap': 'True', 'at': 'True', 'drp_QSO': 'True',
              'bias_LYA': 'True', 'beta_LYA': 'True'}
    main = make_synthetic_dataset(
        tmp_path, cross=True, size='tiny', sample=sample,
        extra_control='grid-domain-pad = 0.1\ngrid-nodes-ap = 12\n'
                      'grid-nodes-at = 12\ngrid-nodes-drp_QSO = 8\n'
                      'grid-domain-drp_QSO = -1.0 1.0\n'
                      'grid-combination = always\nds-matmul = False\n')
    rng = np.random.default_rng(5)
    batch = {'ap': 1 + rng.uniform(-.08, .08, 8),
             'at': 1 + rng.uniform(-.08, .08, 8),
             'drp_QSO': rng.uniform(-0.8, 0.8, 8),
             'bias_LYA': -0.117 * (1 + 0.05 * rng.normal(size=8)),
             'beta_LYA': 1.67 * (1 + 0.05 * rng.normal(size=8))}
    port = VegaInterface(main, device='cpu')
    got = port.chi2_batch(batch).numpy()
    assert len(port.get_collapsed(frozenset(batch))['__grid__'].names) == 3
    monkeypatch.setenv('VEGA_TPU_GRID_COLLAPSE', '0')
    want = np.asarray(JaxInterface(main).chi2_batch(batch))
    np.testing.assert_allclose(got, want, rtol=DENSE_RTOL, atol=DENSE_ATOL)


def test_node_limit_takes_the_dense_path(built, monkeypatch):
    """Past VEGA_TPU_GRID_MAX_NODES both packages leave the names to the
    dense path (vega_tpu/vega_interface.py:809-816): no payload, and the
    port's chi^2 is vega_tpu's within CHI2_RTOL."""
    b = built('plain-4')
    monkeypatch.setenv('VEGA_TPU_GRID_MAX_NODES', '100')
    port = VegaInterface(b.main, device='cpu')
    jax_vega = JaxInterface(b.main)
    assert port.get_collapsed(frozenset(b.names)) == {}
    assert jax_vega.get_collapsed(b.names) == {}
    batch = points(b.sample)
    want = np.asarray(jax_vega.chi2_batch(batch))
    got = port.chi2_batch(batch).numpy()
    assert np.max(np.abs(got - want) / np.abs(want)) <= CHI2_RTOL
