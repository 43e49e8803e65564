"""The broadband polynomials of the PyTorch port against the JAX package
(vega_tpu) on the CPU: the [broadband] section's parsing and its errors,
the design matrices (bit for bit), `compute` at each of pre / post x add /
mul x rp,rt / r,mu, the sky residual, the additive columns as factored
terms, and the model on tiny configurations carrying them
(tests/tools/variant_configs.py's broadband_sky and broadband_mul_pre
specs, a sampled multiplicative coefficient as in tests/test_factored.py,
sampled additive coefficients, and the sky residual sampled beside (ap,
at), which vega_tpu serves through its grid payload with the auto
evaluated densely). Both packages read the same files, made by
vega_tpu.testing.make_synthetic_dataset. Each tolerance stands beside its
use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vega_tpu.broadband_poly import BroadbandPolynomials as JaxBroadband
from vega_tpu.coordinates import Coordinates as JaxCoordinates
from vega_tpu.testing import make_synthetic_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch.broadband_poly import BroadbandPolynomials
from vega_tpu_torch.coordinates import Coordinates
from vega_tpu_torch.factored import FactoredXi, Sampling
from vega_tpu_torch.vega_interface import VegaInterface

BB_RTOL = 1e-14         # a broadband vector, of its largest entry
XI_RTOL = 1e-12         # a model, of its largest entry
CHI2_RTOL = 1e-10       # chi^2 (dense path, nuisance collapse)
DERIV_RTOL = 1e-9       # gradient and Hessian, of their largest entry
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False'
SKY = 'BB-lyaxlya-0-broadband_sky'


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ----------------------------------------------------------------------
# 1. The module on its own
# ----------------------------------------------------------------------
# the model grid (pre) and a distorted grid of another shape (post), so
# the two positions read different coordinates
GRIDS = ((0., 200., 200., 10, 10), (-200., 200., 200., 20, 10))


def both(spec):
    """(port, vega_tpu) BroadbandPolynomials of one [broadband] dict."""
    port = BroadbandPolynomials(spec, 'lyaxlya',
                                *(Coordinates(*g) for g in GRIDS),
                                device='cpu')
    ref = JaxBroadband(spec, 'lyaxlya', *(JaxCoordinates(*g)
                                          for g in GRIDS))
    return port, ref


def coefficient_params(ref, n_rows=None, seed=0):
    """Every coefficient of `ref`'s design matrices (0.05-sized), the sky
    terms' scale and sigma; floats, or (n_rows,) arrays."""
    rng = np.random.default_rng(seed)
    size = None if n_rows is None else n_rows
    params = {}
    for _, names in ref._designs.values():
        for name in names:
            params[name] = 0.05 * rng.normal(size=size)
    for terms in ref.bb_terms.values():
        for term in terms:
            if term['func'] == 'broadband_sky':
                params[term['name'] + '-scale-sky'] = \
                    0.01 + 0.005 * rng.random(size)
                params[term['name'] + '-sigma-sky'] = \
                    30. + 5. * rng.random(size)
    return params


@pytest.mark.parametrize('kind', ['add', 'mul'])
@pytest.mark.parametrize('position', ['pre', 'post'])
@pytest.mark.parametrize('coords', ['rp,rt', 'r,mu'])
def test_design_and_compute_match_jax(kind, position, coords):
    """Two polynomial terms of one position type: the design matrices
    and their coefficient names equal vega_tpu's bit for bit, and
    `compute` agrees (floats, and (B,) rows each against its own JAX
    call) to BB_RTOL."""
    spec = {'bb1': f'{kind} {position} {coords} 0:2:1 0:2:2',
            'bb2': f'{kind} {position} {coords} -1:0:1 0:0:1'}
    port, ref = both(spec)
    assert list(port.designs) == list(ref._designs)
    for key, (design, names) in port.designs.items():
        assert names == ref._designs[key][1]
        assert np.array_equal(design, ref._designs[key][0])
    pos_type = f'{position}-{kind}'
    params = coefficient_params(ref)
    want = np.asarray(ref.compute(params, pos_type))
    got = port.compute(params, pos_type).numpy()
    assert got.shape == want.shape
    assert max_rel(got, want) <= BB_RTOL
    rows = coefficient_params(ref, n_rows=3, seed=1)
    got = port.compute({k: torch.as_tensor(v) for k, v in rows.items()},
                       pos_type).numpy()
    for i in range(3):
        want = np.asarray(ref.compute({k: v[i] for k, v in rows.items()},
                                      pos_type))
        assert max_rel(got[i], want) <= BB_RTOL
    # the other kind at this position has no term
    other = f'{position}-{"mul" if kind == "add" else "add"}'
    assert port.compute(params, other) == ref.compute(params, other)


@pytest.mark.parametrize('position', ['pre', 'post'])
def test_sky_term_matches_jax(position):
    """The Gaussian sky residual, on 0 <= rp < the rp bin size of its
    position's grid, alone and added to a polynomial, against vega_tpu's
    at a point and for (B,) rows to BB_RTOL (the two packages' exp differ
    in the last bit)."""
    spec = {'bb1': f'add {position} rp,rt 0:0:1 0:0:1 broadband_sky',
            'bb2': f'add {position} r,mu 0:1:1 0:2:2'}
    port, ref = both(spec)
    name = SKY
    params = coefficient_params(ref)
    sky_port = port._compute_broadband_sky(name, params, position)
    sky_ref = ref._compute_broadband_sky(
        name, params, ref.model_coordinates if position == 'pre'
        else ref.dist_model_coordinates)
    assert max_rel(sky_port.numpy(), sky_ref) <= BB_RTOL
    assert np.count_nonzero(sky_port.numpy()) == 10    # the first rp bin
    pos_type = f'{position}-add'
    assert max_rel(port.compute(params, pos_type),
                   ref.compute(params, pos_type)) <= BB_RTOL
    rows = coefficient_params(ref, n_rows=2, seed=3)
    got = port._compute_broadband_sky(
        name, {k: torch.as_tensor(v) for k, v in rows.items()}, position)
    for i in range(2):
        want = ref._compute_broadband_sky(
            name, {k: v[i] for k, v in rows.items()},
            ref.model_coordinates if position == 'pre'
            else ref.dist_model_coordinates)
        assert max_rel(got[i].numpy(), want) <= BB_RTOL


@pytest.mark.parametrize('sampled', ['none', 'coefficients', 'sky'])
def test_add_terms_match_jax(sampled):
    """compute_add_terms: each design column with its coefficient (bit
    for bit), then the sky vector (to BB_RTOL) with coefficient 1, as
    vega_tpu's; None when a sky name is sampled, where vega_tpu's returns None
    under a trace; `add_coefficients` gives the terms' coefficients."""
    spec = {'bb1': 'add pre rp,rt 0:1:1 0:1:1',
            'bb2': 'add pre rp,rt 0:0:1 0:0:1 broadband_sky'}
    port, ref = both(spec)
    params = coefficient_params(ref)
    names = {'none': set(), 'coefficients': set(ref._designs[
        ('pre-add', 'BB-lyaxlya-0 add pre rp,rt')][1]),
        'sky': {f'{SKY.replace("-0-", "-1-")}-scale-sky'}}[sampled]
    sampling = Sampling(frozenset(names | {'bias_LYA'}))
    got = port.compute_add_terms(params, 'pre', sampling)

    traced = []

    def jax_terms(scale):
        local = dict(params)
        local[f'{SKY.replace("-0-", "-1-")}-scale-sky'] = scale
        traced.append(ref.compute_add_terms(local, 'pre') is None)
        return scale

    if sampled == 'sky':
        jax.make_jaxpr(jax_terms)(0.01)
        assert got is None and traced == [True]
        return
    want = ref.compute_add_terms(params, 'pre')
    assert len(got) == len(want) == 5
    for (c_got, v_got), (c_want, v_want) in zip(got, want):
        assert c_got == c_want
        if c_got == 1.0:
            assert max_rel(v_got.numpy(), v_want) <= BB_RTOL
        else:
            assert np.array_equal(v_got.numpy(), np.asarray(v_want))
    assert port.add_coefficients(params, 'pre') == [c for c, _ in want]
    assert port.compute_add_terms(params, 'post', sampling) == []


@pytest.mark.parametrize('line', [
    'add pre rp,rt 0:0:1',
    'sub pre rp,rt 0:0:1 0:0:1',
    'add mid rp,rt 0:0:1 0:0:1',
    'add pre x,y 0:0:1 0:0:1',
    'add pre rp,rt 0:0 0:0:1',
    'add pre rp,rt 0:0:1 0:0:1 broadband_moon',
])
def test_bad_sections_raise_as_jax(line):
    """Each malformed [broadband] entry raises vega_tpu's ValueError with
    vega_tpu's message."""
    with pytest.raises(ValueError) as want:
        JaxBroadband({'bb1': line}, 'lyaxlya',
                     *(JaxCoordinates(*g) for g in GRIDS))
    with pytest.raises(ValueError) as got:
        both({'bb1': line})
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# 2. The model on tiny configurations with a [broadband] section
# ----------------------------------------------------------------------
# each case: ([broadband] of the auto, its parameters, [sample], a
# distortion matrix in the data, the sampled points)
CASES = {
    # tests/tools/variant_configs.py's broadband_sky: the sky residual
    # after the distortion, fixed
    'sky_post': (
        {'bb1': 'add post rp,rt 0:0:1 0:0:1 broadband_sky'},
        {f'{SKY}-scale-sky': 0.00896, f'{SKY}-sigma-sky': 32.7},
        ('bias_LYA', 'beta_LYA', 'bias_QSO'), True,
        [{'bias_LYA': -0.12, 'beta_LYA': 1.6, 'bias_QSO': 3.6}]),
    # broadband_mul_pre: a multiplicative polynomial before the
    # distortion, fixed at nonzero coefficients
    'mul_pre': (
        {'bb1': 'mul pre r,mu 0:1:1 0:2:2'},
        {'BB-lyaxlya-0 mul pre r,mu (0,0)': 0.05,
         'BB-lyaxlya-0 mul pre r,mu (0,2)': -0.08,
         'BB-lyaxlya-0 mul pre r,mu (1,0)': 0.04,
         'BB-lyaxlya-0 mul pre r,mu (1,2)': -0.03},
        ('bias_LYA', 'beta_LYA', 'bias_QSO'), True,
        [{'bias_LYA': -0.11, 'beta_LYA': 1.7, 'bias_QSO': 3.8}]),
    # tests/test_factored.py: a sampled multiplicative coefficient
    # densifies the auto
    'mul_sampled': (
        {'bb1': 'mul pre r,mu 0:0:1 0:0:1'},
        {'BB-lyaxlya-0 mul pre r,mu (0,0)': 0.15},
        ('bias_LYA', 'beta_LYA', 'BB-lyaxlya-0 mul pre r,mu (0,0)'), False,
        [{'bias_LYA': -0.12, 'beta_LYA': 1.6,
          'BB-lyaxlya-0 mul pre r,mu (0,0)': 0.3}]),
    # additive polynomials before and after the distortion with sampled
    # coefficients: factored columns whose coefficients are parameters
    'add_sampled': (
        {'bb1': 'add pre rp,rt 0:1:1 0:1:1',
         'bb2': 'add post r,mu -2:0:1 0:2:2'},
        {**{f'BB-lyaxlya-0 add pre rp,rt ({i},{j})': 0.
            for i in (0, 1) for j in (0, 1)},
         **{f'BB-lyaxlya-1 add post r,mu ({i},{j})': 0.
            for i in (-2, -1, 0) for j in (0, 2)}},
        ('bias_LYA', 'beta_LYA', 'BB-lyaxlya-0 add pre rp,rt (1,0)',
         'BB-lyaxlya-1 add post r,mu (-1,2)'), True,
        [{'bias_LYA': -0.12, 'beta_LYA': 1.6,
          'BB-lyaxlya-0 add pre rp,rt (1,0)': 2e-4,
          'BB-lyaxlya-1 add post r,mu (-1,2)': -3e-5}]),
    # the published configuration's sky term, sampled beside (ap, at):
    # vega_tpu's grid route (the cross from the payload, the auto dense)
    'sky_sampled': (
        {'bb1': 'add pre rp,rt 0:0:1 0:0:1 broadband_sky'},
        {f'{SKY}-scale-sky': 0.01, f'{SKY}-sigma-sky': 31.},
        ('ap', 'at', 'bias_LYA', 'beta_LYA', f'{SKY}-scale-sky',
         f'{SKY}-sigma-sky'), False,
        [{'ap': 1.02, 'at': 0.99, 'bias_LYA': -0.117, 'beta_LYA': 1.67,
          f'{SKY}-scale-sky': 0.05, f'{SKY}-sigma-sky': 20.},
         {'ap': 0.97, 'at': 1.03, 'bias_LYA': -0.117, 'beta_LYA': 1.67,
          f'{SKY}-scale-sky': 0.2, f'{SKY}-sigma-sky': 45.}]),
}
LIMITS = {'BB-lyaxlya-0 mul pre r,mu (0,0)': '-1. 1. 0.15 0.01',
          'BB-lyaxlya-0 add pre rp,rt (1,0)': '-1. 1. 0. 1e-4',
          'BB-lyaxlya-1 add post r,mu (-1,2)': '-1. 1. 0. 1e-4',
          f'{SKY}-scale-sky': '0 0.5 0.01 0.1',
          f'{SKY}-sigma-sky': '10 60 31. 0.1'}


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
def configs(env, tmp_path_factory):
    """{case: main.ini}: a tiny auto + cross dataset made by vega_tpu,
    the auto's ini given the case's [broadband], main.ini its parameters
    and [sample]."""
    out = {}
    for case, (section, params, names, dmat, _) in CASES.items():
        work = tmp_path_factory.mktemp(case)
        main = make_synthetic_dataset(
            work, cross=True, size='tiny', with_distortion=dmat,
            sample={n: LIMITS.get(n, 'True') for n in names},
            extra_control=CONTROL)
        with open(work / 'lyaxlya.ini', 'a') as fh:
            fh.write('\n[broadband]\n' + ''.join(
                f'{k} = {v}\n' for k, v in section.items()))
        config = configparser.ConfigParser()
        config.optionxform = lambda option: option
        config.read(main)
        for name, value in params.items():
            config['parameters'][name] = str(value)
        for name in names:
            config['sample'][name] = LIMITS.get(name, 'True')
        with open(main, 'w') as fh:
            config.write(fh)
        out[case] = main
    return out


def interfaces(main, env, factored):
    """(vega_tpu, port) on `main`, built with VEGA_TPU_FACTORED set or
    not (vega_tpu reads it when it traces)."""
    if not factored:
        env.setenv('VEGA_TPU_FACTORED', '0')
    pair = JaxInterface(main), VegaInterface(main, device='cpu')
    env.delenv('VEGA_TPU_FACTORED', raising=False)
    return pair


def rows_around(point, n_rows, seed):
    rng = np.random.default_rng(seed)
    return {k: v + 0.01 * (abs(v) or 1e-4) * rng.normal(size=n_rows)
            for k, v in point.items()}


@pytest.mark.parametrize('case', list(CASES))
def test_model_factored_equals_dense(configs, env, case):
    """The port's model with the case's names sampled (factored where the
    broadband allows it) against its dense model at the same point, and
    the dense model against vega_tpu's."""
    names, points = CASES[case][2], CASES[case][4]
    ref, port = interfaces(configs[case], env, factored=True)
    params = dict(port.params, **points[0])
    sampling = Sampling(frozenset(names))
    for name, model in port.models.items():
        factored, _ = model.compute(params, port._pk_full, port._pk_smooth,
                                    sampling=sampling)
        dense, _ = model.compute(params, port._pk_full, port._pk_smooth)
        got = (factored.dense() if isinstance(factored, FactoredXi)
               else factored).reshape(-1)
        assert max_rel(got, dense[0]) <= XI_RTOL
        kept = isinstance(factored, FactoredXi)
        assert kept == ('ap' not in names and (
            name == 'qsoxlya'
            or case in ('sky_post', 'mul_pre', 'add_sampled')))
    got = port.compute_model(points[0], run_init=False)
    want = ref.compute_model(points[0], run_init=False)
    for name in got:
        assert max_rel(got[name], want[name]) <= XI_RTOL


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('regime', ['dense', 'factored'])
def test_chi2_batch_matches_jax(configs, env, case, regime):
    """chi2_batch over rows around the case's points against vega_tpu's,
    by the route vega_tpu takes: dense; or factored, where the port
    serves what vega_tpu serves (the nuisance collapse of what stays
    factored, or with (ap, at) sampled the grid payload of the cross and
    the auto densely), within vega_tpu's mode budget when a payload
    serves."""
    names, points = CASES[case][2], CASES[case][4]
    ref, port = interfaces(configs[case], env, factored=regime != 'dense')
    if regime == 'dense':
        env.setenv('VEGA_TPU_FACTORED', '0')
    rows = {k: np.concatenate([rows_around(p, 3, i)[k]
                               for i, p in enumerate(points)])
            for k in points[0]}
    served = set(port.get_collapsed(names))
    assert served == set(ref.get_collapsed(names))
    got = port.chi2_batch(rows).numpy()
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in rows.items()}))
    env.delenv('VEGA_TPU_FACTORED', raising=False)
    assert np.all(got < 1e99)
    if '__grid__' in served:
        assert served == {'__grid__', 'qsoxlya'}
        assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * want)
    else:
        assert served == (set() if regime == 'dense' else
                          {'qsoxlya'} if case == 'mul_sampled'
                          else {'lyaxlya', 'qsoxlya'})
        assert max_rel(got, want) <= CHI2_RTOL


@pytest.mark.parametrize('case', ['sky_post', 'mul_sampled', 'add_sampled',
                                  'sky_sampled'])
def test_value_gradient_hessian_match_jax(configs, env, case):
    """chi^2, its gradient and Hessian over the sampled names at the
    case's first point, by vega_tpu's route (the sky-sampled case through
    the payload, held within 1e-6 relative as
    tests/test_torch_derivatives.py holds a payload's)."""
    names, points = CASES[case][2], CASES[case][4]
    ref, port = interfaces(configs[case], env, factored=True)
    tol = 1e-6 if 'ap' in names else DERIV_RTOL
    point = points[0]
    value, grad = port.chi2_value_and_gradient(point)
    hess = port.chi2_hessian(point, names)
    value_j, grad_j = ref.chi2_value_and_gradient(point)
    hess_j = ref.chi2_hessian(point, list(names))
    assert max_rel(value, value_j) <= tol
    assert max_rel([grad[n] for n in names],
                   [grad_j[n] for n in names]) <= tol
    assert max_rel([[hess[a][b] for b in names] for a in names],
                   [[hess_j[a][b] for b in names] for a in names]) <= tol


def test_sky_sampled_grid_route_matches_jax(configs, env):
    """The sky residual sampled beside (ap, at): vega_tpu's sweep finds
    the auto dense (the sky term read a sampled name), so its payload
    holds the cross alone and the auto is evaluated densely at the true
    values. The port's grid chi^2 is held to vega_tpu's within the mode
    budget; the gap between the grid and the dense chi^2 is vega_tpu's
    own (the cross's payload at 8 x 8 nodes) and is reported."""
    names, points = CASES['sky_sampled'][2], CASES['sky_sampled'][4]
    ref, port = interfaces(configs['sky_sampled'], env, factored=True)
    payload, ref_payload = port.get_collapsed(names), ref.get_collapsed(names)
    assert set(payload) == set(ref_payload) == {'__grid__', 'qsoxlya'}
    assert payload['__grid__'].names == ('ap', 'at')
    assert max_rel(payload['qsoxlya']['cref'],
                   ref_payload['qsoxlya']['cref']) <= 1e-12
    batch = {k: np.array([p[k] for p in points]) for k in names}
    got = port.chi2_batch(batch).numpy()
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * want)
    dense_ref, dense_port = interfaces(configs['sky_sampled'], env,
                                       factored=False)
    env.setenv('VEGA_TPU_FACTORED', '0')
    dense = np.asarray(dense_ref.chi2_batch({k: jnp.asarray(v)
                                             for k, v in batch.items()}))
    assert max_rel(dense_port.chi2_batch(batch).numpy(), dense) <= CHI2_RTOL
    env.delenv('VEGA_TPU_FACTORED')
    print('grid - dense chi^2 (vega_tpu):', want - dense)
