"""The grid collapse of the PyTorch port (vega_tpu_torch.gridcollapse,
VegaInterface.get_collapsed / chi2_batch on sampled (ap, at), and
parallel.BatchedLikelihood) against the JAX package's, on the tiny
synthetic auto+cross dataset with 8 x 8 Chebyshev nodes and the JAX
package's exact f64 payload contractions (ds-matmul = False)."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import jax
import numpy as np
import pytest
import torch

import vega_tpu.gridcollapse as jgc
from vega_tpu.factored import grid_trace
from vega_tpu.statics import STATICS
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.model import Model
from vega_tpu_torch.ops.spline_combine import (KnotGrid,
                                               spline_legendre_combine)
from vega_tpu_torch.parallel import BatchedLikelihood
from vega_tpu_torch.vega_interface import VegaInterface

CORRS = ('lyaxlya', 'qsoxlya')
NAMES = ('ap', 'at', 'beta_LYA', 'bias_LYA')
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
NODE_RTOL = 1e-11
PAYLOAD_RTOL = 1e-12


def rows(n, seed):
    """n points inside the node domain ap, at in [0.75, 1.25]."""
    rng = np.random.default_rng(seed)
    return {'ap': rng.uniform(0.8, 1.2, n), 'at': rng.uniform(0.8, 1.2, n),
            'bias_LYA': -0.117 * (1 + 0.05 * rng.normal(size=n)),
            'beta_LYA': 1.67 * (1 + 0.05 * rng.normal(size=n))}


@pytest.fixture(scope='module')
def grid(tmp_path_factory):
    """(JAX interface, port interface, main.ini) on one tiny dataset; the
    JAX payload is built from the defaults with no disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        main = jax_make_dataset(
            tmp_path_factory.mktemp('grid'), cross=True, size='tiny',
            extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n'
                          'ds-matmul = False')
        yield JaxInterface(main), VegaInterface(main, device='cpu'), main


def within_budget(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))


def rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))
                  / np.abs(np.asarray(want)))


# ----------------------------------------------------------------------
# Host functions copied from vega_tpu.gridcollapse
# ----------------------------------------------------------------------
SPEC_ARGS = (('ap', 'at'), (0.75, 0.9), (1.25, 1.1), (8, 6), (1.0, 1.02))
WIDE_ARGS = (('ap', 'at', 'drp_QSO', 'sigma_velo_disp_lorentz_QSO'),
             (0.75, 0.75, -1.0, 0.0), (1.25, 1.25, 1.0, 15.0),
             (32, 32, 12, 12), (1.0, 1.0, 0.0, 6.86))


def _coef(seed=4, t=6, n=48):
    """A Chebyshev coefficient matrix whose rows decay, so the budgeted
    cut keeps a strict subset."""
    rng = np.random.default_rng(seed)
    decay = np.exp(-0.35 * np.arange(n))[:, None]
    return rng.normal(size=(n, t * t + t + 1)) * decay


def _host_case(case, mod):
    spec = mod.GridSpec(*SPEC_ARGS)
    wide = mod.GridSpec(*WIDE_ARGS)
    modes = np.stack(np.unravel_index(np.arange(48), spec.degrees)
                     ).astype(np.int32)
    if case == 'cheb':
        return [mod.cheb_nodes(n) for n in (1, 5, 32)] + [
            mod.cheb_transform_matrix(n) for n in (1, 8, 32)]
    if case == 'component_nodes':
        return [mod.component_nodes(spec, spec.degrees),
                mod.component_nodes(wide, (1, 16, 32, 6))]
    if case == 'plan_components':
        return [repr(mod.plan_components(spec)),
                repr(mod.plan_components(wide)),
                repr(mod.plan_components(wide, order=2)),
                repr(mod.plan_components(spec, mode='always')),
                repr([mod._level_degrees(d) for d in (1, 2, 3, 12, 32)])]
    if case == 'mode_probe_psi':
        return [mod._mode_probe_psi(spec, modes, 64,
                                    np.random.default_rng(3))]
    if case == 'budgeted_cut':
        coef = _coef()
        psi = mod._mode_probe_psi(spec, modes, 64, np.random.default_rng(3))
        return [mod._budgeted_cut(
            np.linalg.norm(coef, axis=1), coef, psi,
            lambda d: float(np.abs(d).max()), budget)
            for budget in (1e-3, 1e-1, 10.0)]
    if case == 'select_payload_modes':
        return [np.concatenate(mod.select_payload_modes(
            _coef(), 6, spec, budget, 2.5, modes=modes))
            for budget in (0.0, 1e-3, 1e-1)]
    if case == 'svd_compress':
        return list(mod._svd_compress(_coef(), 1e-12)) + list(
            mod._svd_compress(_coef(5), 1e-3))
    if case == 'finalize_corr_payload':
        out = mod.finalize_corr_payload(_coef(), modes, np.arange(6.0),
                                        spec, 1e-2, 3.0, 1e-10)
        return [out[k] for k in sorted(out)]
    if case == 'grid_params':
        names = ['ap', 'at', 'aiso', 'phi_smooth', 'alpha_smooth_lyaxlya',
                 'drp_QSO', 'sigma_velo_disp_lorentz_QSO', 'bias_LYA',
                 'sigmaNL_par', 'beta_QSO']
        return [[mod.is_known_grid_param(n) for n in names],
                sorted(mod.ALPHA_LIKE), mod.GRID_WALL_CHI2,
                repr(spec), spec.n_nodes]
    raise KeyError(case)


@pytest.mark.parametrize('case', [
    'cheb', 'component_nodes', 'plan_components', 'mode_probe_psi',
    'budgeted_cut', 'select_payload_modes', 'svd_compress',
    'finalize_corr_payload', 'grid_params'])
def test_host_functions_equal_jax(case):
    got, want = _host_case(case, gc), _host_case(case, jgc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert np.array_equal(g, w)
        else:
            assert g == w


def test_payload_files_round_trip(grid, tmp_path):
    """A vega_tpu payload file loads in the port, and the port's file in
    vega_tpu, part for part."""
    jax_vega, port, _ = grid
    jax_payload = jax_vega.get_collapsed(NAMES)
    jgc.save_payload(tmp_path / 'jax.npz', jax_payload)
    gc.save_payload(tmp_path / 'port.npz', port.get_collapsed(NAMES))
    for got, want in ((gc.load_payload(tmp_path / 'jax.npz'), jax_payload),
                      (jgc.load_payload(tmp_path / 'port.npz'),
                       port.get_collapsed(NAMES))):
        g_spec, w_spec = got['__grid__'], want['__grid__']
        assert (g_spec.names, g_spec.lo, g_spec.hi, g_spec.degrees,
                g_spec.ref) == (w_spec.names, w_spec.lo, w_spec.hi,
                                w_spec.degrees, w_spec.ref)
        assert sorted(got) == sorted(want)
        for name in CORRS:
            assert sorted(got[name]) == sorted(want[name])
            for part, arr in want[name].items():
                assert np.array_equal(got[name][part], arr)


# ----------------------------------------------------------------------
# The node sweep
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def node_tensors(grid):
    """A(g), e(g) and c0 at 3 nodes, from vega_tpu's _grid_collapse_node
    run as its sweep runs it (jit + STATICS.bind + grid_trace) and from
    the port's."""
    jax_vega, port, _ = grid
    nodes = np.array([[0.8, 1.2], [1.0, 1.0], [1.13, 0.91]])
    base = {n: float(jax_vega.params.get(n, 0.0)) for n in NAMES}
    jax_vega._ensure_static_refs()

    def node_fn(gvals, base, dvecs, statics):
        sp = dict(base, ap=gvals[0], at=gvals[1])
        with STATICS.bind(statics), grid_trace(('ap', 'at')):
            return jax_vega._grid_collapse_node(sp, dvecs)

    fn = jax.jit(jax.vmap(node_fn, in_axes=(0, None, None, None),
                          out_axes=(0, None, 0)))
    want = fn(nodes, base, jax_vega._current_data_vecs(),
              STATICS.device_tree())
    got = port._grid_collapse_node(
        dict(base, ap=nodes[:, 0], at=nodes[:, 1]), NAMES, ('ap', 'at'), {})
    return got, want


@pytest.mark.parametrize('name', CORRS)
def test_sweep_node_tensors_match_jax(node_tensors, name):
    (payload, c0s, bad), (jax_payload, jax_c0s, jax_bad) = node_tensors
    assert not bad.any() and not np.asarray(jax_bad).any()
    for part in ('A', 'e'):
        got = payload[name][part].numpy()
        want = np.asarray(jax_payload[name][part])
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= NODE_RTOL * np.max(np.abs(want))
    np.testing.assert_allclose(c0s[name].numpy(), np.asarray(jax_c0s[name]),
                               rtol=1e-15, atol=0)


def test_sweep_raises_out_of_bounds(grid):
    """A node whose rescaled coordinates leave the transform's knots
    raises, as vega_tpu's sweep does."""
    _, port, _ = grid
    spec = gc.GridSpec(('ap', 'at'), (0.9, 0.9), (100.0, 1.1), (3, 2),
                       (1.0, 1.0))
    with pytest.raises(ValueError, match='out of bounds'):
        gc.build_grid_payload(port, NAMES, ('ap', 'at'), spec)


# ----------------------------------------------------------------------
# Per-evaluation chi^2 and dispatch
# ----------------------------------------------------------------------
def test_grid_chi2_on_a_jax_payload(grid, tmp_path):
    """The port's per-evaluation grid chi^2 on vega_tpu's own payload
    (saved by vega_tpu, loaded by the port) against vega_tpu's
    chi2_batch: only the evaluation differs."""
    jax_vega, _, main = grid
    jgc.save_payload(tmp_path / 'p.npz', jax_vega.get_collapsed(NAMES))
    port = VegaInterface(main, device='cpu')
    port.use_grid_payload(NAMES, gc.load_payload(tmp_path / 'p.npz'))
    batch = rows(16, 1)
    want = np.asarray(jax_vega.chi2_batch(batch))
    got = port.chi2_batch(batch).numpy()
    assert rel(got, want) <= PAYLOAD_RTOL


@pytest.mark.parametrize('entry', ['chi2_batch', 'log_lik_batch', 'chi2',
                                   'log_lik'])
def test_defaults_dispatch_as_jax(grid, entry):
    """With no switches set, a call that samples (ap, at) is served by
    each package's own grid payload: the port agrees with vega_tpu's
    default (grid) chi^2 within the mode budget, not only with its dense
    chi^2, which differs by the interpolation error."""
    jax_vega, port, _ = grid
    batch = rows(16, 2)
    if entry in ('chi2', 'log_lik'):
        point = {k: float(v[3]) for k, v in batch.items()}
        got, want = getattr(port, entry)(point), getattr(jax_vega,
                                                         entry)(point)
    else:
        got = getattr(port, entry)(batch).numpy()
        want = np.asarray(getattr(jax_vega, entry)(batch))
    within_budget(got, want)


def test_grid_differs_from_dense_by_the_interpolation(grid, monkeypatch):
    """The grid payload is what serves the defaults: on 8 x 8 nodes its
    chi^2 is off the dense chi^2 by far more than the mode budget, in
    both packages alike."""
    jax_vega, port, main = grid
    batch = rows(16, 2)
    grid_chi2 = port.chi2_batch(batch).numpy()
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    dense = VegaInterface(main, device='cpu')
    assert dense.get_collapsed(NAMES) == {}
    dense_chi2 = dense.chi2_batch(batch).numpy()
    assert np.max(np.abs(grid_chi2 - dense_chi2)) > 100 * GRID_ABS
    want_dense = np.asarray(jax_vega.chi2_batch(batch))
    assert rel(dense_chi2, want_dense) <= 1e-9


def test_grid_names_alone_are_served_by_the_payload(grid, monkeypatch):
    """Sampling only (ap, at): the chi^2 still follows (ap, at) through
    the payload and equals the 4-name sampled set's at the nuisance
    defaults. vega_tpu departs here: it returns the reference-point
    chi^2. So the port is held to vega_tpu's grid chi^2 of the 4-name
    set, and to vega_tpu's dense chi^2 within vega_tpu's own grid - dense
    difference at the same points."""
    jax_vega, port, _ = grid
    batch = rows(6, 4)
    alone = {k: batch[k] for k in ('ap', 'at')}
    at_defaults = dict(batch, bias_LYA=np.full(6, port.params['bias_LYA']),
                       beta_LYA=np.full(6, port.params['beta_LYA']))
    grid_only = port.chi2_batch(alone)
    within_budget(grid_only.numpy(), port.chi2_batch(at_defaults).numpy())
    assert torch.unique(grid_only).numel() == 6

    jax_grid = np.asarray(jax_vega.chi2_batch(at_defaults))
    within_budget(grid_only.numpy(), jax_grid)
    # the departure: vega_tpu's chi^2 at the reference point (~0 on this
    # noiseless dataset) wherever (ap, at) are
    assert np.all(np.abs(np.asarray(jax_vega.chi2_batch(alone))) <= 1e-12)
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    jax_dense = np.asarray(jax_vega.chi2_batch(at_defaults))
    assert np.all(np.abs(grid_only.numpy() - jax_dense)
                  <= np.abs(jax_grid - jax_dense) + GRID_ABS)
    assert np.max(np.abs(jax_grid - jax_dense)) > 100 * GRID_ABS


def test_collapses_selected_by_names(grid):
    _, port, _ = grid
    assert '__grid__' in port.get_collapsed(NAMES)
    nuisance = port.get_collapsed(('bias_LYA', 'beta_LYA'))
    assert '__grid__' not in nuisance and sorted(nuisance) == list(CORRS)
    assert port.get_collapsed(()) == {}
    assert port.get_collapsed(NAMES, with_data_terms=False) == {}


def test_wall_outside_the_domain_matches_jax(grid):
    jax_vega, port, _ = grid
    batch = {'ap': np.array([1.3, 1.4, 0.6, 1.0]),
             'at': np.array([1.0, 1.0, 1.0, 1.35]),
             'bias_LYA': np.full(4, -0.117), 'beta_LYA': np.full(4, 1.67)}
    want = np.asarray(jax_vega.chi2_batch(batch))
    got = port.chi2_batch(batch).numpy()
    assert np.all(got > 1e6) and np.all(got < 1e100)
    assert rel(got, want) <= PAYLOAD_RTOL


def test_batched_likelihood_equals_chi2_batch(grid):
    _, port, _ = grid
    batch = rows(11, 3)
    want = port.chi2_batch(batch)
    want_log_lik = port.log_lik_batch(batch)
    for chunk_rows in (None, 1, 4, 64):
        bl = BatchedLikelihood(port, chunk_rows=chunk_rows)
        got = bl.chi2(batch)
        assert torch.allclose(got, want, rtol=1e-13, atol=0)
        assert torch.allclose(bl.log_lik(batch), want_log_lik, rtol=1e-13,
                              atol=0)
    with pytest.raises(ValueError):
        BatchedLikelihood(port, chunk_rows=0)


@pytest.mark.parametrize('names', [('beta_LYA', 'bias_LYA'), NAMES],
                         ids=['nuisance', 'grid'])
def test_collapse_build_checks_the_coefficient_program(grid, monkeypatch,
                                                       names):
    """A coefficient program that drifts from the factored model's terms
    in value, with the term count unchanged, stops the collapse from
    being built."""
    _, _, main = grid
    port = VegaInterface(main, device='cpu')
    coefficients = Model.coefficients

    def drifted(self, pars, n_rows):
        coeffs = coefficients(self, pars, n_rows).clone()
        coeffs[:, -1] *= 1 + 1e-9
        return coeffs

    monkeypatch.setattr(Model, 'coefficients', drifted)
    with pytest.raises(AssertionError, match='coefficient program'):
        port.get_collapsed(names)


def test_sampling_limits_rebuild_the_payload(grid):
    """The payload depends on the sampling limits (through
    measure_dc_max): a change of limits builds a new one."""
    _, _, main = grid
    port = VegaInterface(main, device='cpu')
    first = port.get_collapsed(NAMES)
    assert port.get_collapsed(NAMES) is first
    port.sample_params['limits']['bias_LYA'] = (-0.2, -0.05)
    second = port.get_collapsed(NAMES)
    assert second is not first
    assert float(second['qsoxlya']['dc_max']) != float(
        first['qsoxlya']['dc_max'])


# ----------------------------------------------------------------------
# The kernel wrapper's grouped layout (plain version on the CPU)
# ----------------------------------------------------------------------
def _grouped_inputs(n_x=3, group=4, n_ell=2, n_q=7):
    rng = np.random.default_rng(6)
    grid_ = KnotGrid.build(np.linspace(0.0, 1.0, 16), 'cpu')
    y = torch.as_tensor(rng.normal(size=(n_x * group, n_ell, 16)))
    m = torch.as_tensor(rng.normal(size=(n_x * group, n_ell, 16)))
    x = torch.as_tensor(rng.uniform(-0.1, 1.1, (n_x, n_q)))
    leg = torch.as_tensor(rng.normal(size=(n_x, n_ell, n_q)))
    return grid_, y, m, x, leg


def test_grouped_rows_equal_repeated_coordinates():
    grid_, y, m, x, leg = _grouped_inputs()
    got = spline_legendre_combine(grid_, y, m, x, leg, group=4)
    want = spline_legendre_combine(grid_, y, m, x.repeat_interleave(4, 0),
                                   leg.repeat_interleave(4, 0))
    assert torch.equal(got, want)
    shared = spline_legendre_combine(grid_, y, m, x[:1].expand(3, -1),
                                     leg[:1].expand(3, -1, -1), group=4)
    assert torch.equal(shared, spline_legendre_combine(
        grid_, y, m, x[:1].expand(12, -1), leg[:1].expand(12, -1, -1)))


@pytest.mark.parametrize('case', ['zero', 'not_dividing', 'float',
                                  'x_rows', 'leg_rows'])
def test_grouped_layout_checks(case):
    grid_, y, m, x, leg = _grouped_inputs()
    group = 4
    if case == 'zero':
        group = 0
    elif case == 'not_dividing':
        group = 5
    elif case == 'float':
        group = 4.0
    elif case == 'x_rows':
        x = x[:2]
    elif case == 'leg_rows':
        leg = torch.cat([leg, leg])
    with pytest.raises(ValueError):
        spline_legendre_combine(grid_, y, m, x, leg, group=group)
