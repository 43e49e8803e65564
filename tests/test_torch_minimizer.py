"""The PyTorch port's Minimizer (vega_tpu_torch.minimizer, numpy and scipy
only) against the JAX package's (vega_tpu.minimizer) on the same
analytic chi^2 functions: the two run the same host code, so every result
(values, errors, covariance, fval, EDM, validity) is equal, bit for bit.
Cases: those of tests/test_minimizer_newton.py, the bias-only first
stage, a non-quadratic chi^2 with limits, finite differences, and fixed
parameters."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vega_tpu.minimizer import Minimizer as JaxMinimizer
from vega_tpu_torch.minimizer import CovarianceView, Minimizer

REPO = Path(__file__).resolve().parents[1]


def quadratic(center, hess, names=None):
    """chi2(x) = (x-c)^T H (x-c) / 2 with analytic derivatives."""
    center = np.asarray(center, dtype=float)
    hess = np.asarray(hess, dtype=float)
    names = names or [f'p{i}' for i in range(len(center))]

    def vec(params):
        return np.array([params[n] for n in names], dtype=float)

    def chi2(params):
        d = vec(params) - center
        return float(d @ hess @ d / 2.0)

    def grad(params):
        return dict(zip(names, hess @ (vec(params) - center)))

    def valgrad(params):
        return chi2(params), grad(params)

    def hess_func(params, free_names):
        idx = [names.index(n) for n in free_names]
        sub = hess[np.ix_(idx, idx)]
        return {n1: {n2: float(sub[i, j])
                     for j, n2 in enumerate(free_names)}
                for i, n1 in enumerate(free_names)}

    return names, {'chi2_func': chi2, 'grad_func': grad,
                   'valgrad_func': valgrad, 'hess_func': hess_func}


def rosenbrock_bias():
    """A curved valley, chi2 = 100 (b - a^2)^2 + (1 - a)^2 + (c - 0.3 b)^2
    over (a, bias_b, c), with its exact gradient and Hessian."""
    names = ['a', 'bias_b', 'c']

    def chi2(p):
        a, b, c = p['a'], p['bias_b'], p['c']
        return float(100 * (b - a * a) ** 2 + (1 - a) ** 2
                     + (c - 0.3 * b) ** 2)

    def grad(p):
        a, b, c = p['a'], p['bias_b'], p['c']
        return {'a': -400 * a * (b - a * a) - 2 * (1 - a),
                'bias_b': 200 * (b - a * a) - 0.6 * (c - 0.3 * b),
                'c': 2 * (c - 0.3 * b)}

    def hess(p, free_names):
        a, b = p['a'], p['bias_b']
        full = {'a': {'a': 1200 * a * a - 400 * b + 2, 'bias_b': -400 * a,
                      'c': 0.0},
                'bias_b': {'a': -400 * a, 'bias_b': 200.18, 'c': -0.6},
                'c': {'a': 0.0, 'bias_b': -0.6, 'c': 2.0}}
        return {n1: {n2: float(full[n1][n2]) for n2 in free_names}
                for n1 in free_names}

    return names, {'chi2_func': chi2, 'grad_func': grad,
                   'valgrad_func': lambda p: (chi2(p), grad(p)),
                   'hess_func': hess}


def sample_params(names, values, limits, errors=0.1):
    return {
        'values': dict(zip(names, values)),
        'errors': {n: errors for n in names},
        'limits': {n: limits.get(n, (None, None)) for n in names},
        'fix': {n: False for n in names},
    }


HESS3 = [[4.0, 1.0, 0.0], [1.0, 3.0, 0.5], [0.0, 0.5, 2.0]]


def case(name):
    """(functions, sample_params, minimize() overrides) of one case."""
    if name == 'newton_quadratic':
        names, funcs = quadratic([0.3, -1.2, 2.5], HESS3)
        return funcs, sample_params(names, [0.0] * 3, {}), None
    if name == 'active_bound':
        names, funcs = quadratic([1.5, 0.0], [[2.0, 0.6], [0.6, 1.0]])
        return funcs, sample_params(names, [0.0, 0.0],
                                    {'p0': (-5.0, 1.0)}), None
    if name == 'bias_first_stage':
        names, funcs = quadratic([-0.11, 1.7, 1.02], HESS3,
                                 names=['bias_LYA', 'beta_LYA', 'ap'])
        return funcs, sample_params(names, [-0.2, 1.0, 0.9],
                                    {'ap': (0.5, 1.5)}), None
    if name == 'nonquadratic_limits':
        names, funcs = rosenbrock_bias()
        return funcs, sample_params(names, [-0.5, 0.8, 0.0],
                                    {'a': (-2.0, 0.9), 'bias_b': (0.0, 2.0),
                                     'c': (-1.0, 1.0)}), None
    if name == 'no_hessian':
        names, funcs = quadratic([0.7, -0.4], [[3.0, 0.0], [0.0, 5.0]])
        del funcs['hess_func']
        return funcs, sample_params(names, [0.0, 0.0], {}), None
    if name == 'finite_differences':
        names, funcs = quadratic([0.7, -0.4], [[3.0, 0.5], [0.5, 5.0]])
        return ({'chi2_func': funcs['chi2_func']},
                sample_params(names, [0.0, 0.0], {}), None)
    if name == 'gradient_only':
        names, funcs = quadratic([0.7, -0.4], [[3.0, 0.5], [0.5, 5.0]])
        return ({'chi2_func': funcs['chi2_func'],
                 'grad_func': funcs['grad_func']},
                sample_params(names, [0.0, 0.0], {}), None)
    if name == 'fixed_and_overrides':
        names, funcs = quadratic([0.3, -1.2, 2.5], HESS3)
        return funcs, sample_params(names, [0.0] * 3, {}), {
            'fix': {'p1': True}, 'values': {'p1': -1.0, 'p0': 0.5},
            'limits': {'p2': (0.0, 2.0)}}
    raise KeyError(name)


CASES = ['newton_quadratic', 'active_bound', 'bias_first_stage',
         'nonquadratic_limits', 'no_hessian', 'finite_differences',
         'gradient_only', 'fixed_and_overrides']


def results(mini):
    return (mini.values, mini.errors, np.array(mini.covariance),
            mini.covariance.to_dict(), dict(mini.fmin.items()),
            (mini.minuit.valid, mini.minuit.accurate),
            [(p.name, p.value, p.error) for p in mini.params])


@pytest.mark.parametrize('name', CASES)
def test_minimizer_equals_jax(name, capsys):
    funcs, sample, overrides = case(name)
    port, jax_ = Minimizer(**funcs, sample_params=sample), JaxMinimizer(
        **funcs, sample_params=sample)
    port.minimize(overrides)
    jax_.minimize(overrides)
    got, want = results(port), results(jax_)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        elif isinstance(w, dict) and 'edm' in w and np.isnan(w['edm']):
            assert np.isnan(g['edm'])
            assert {k: v for k, v in g.items() if k != 'edm'} == {
                k: v for k, v in w.items() if k != 'edm'}
        else:
            assert g == w
    assert 'bestfit chi2' in capsys.readouterr().out


def test_minimizer_finds_the_minimum():
    """The equal results are the right ones: the exact Newton polish on a
    quadratic, and the pinned component of the bounded case (the checks
    of tests/test_minimizer_newton.py on the port)."""
    funcs, sample, _ = case('newton_quadratic')
    mini = Minimizer(**funcs, sample_params=sample)
    mini.minimize()
    for n, c in zip(['p0', 'p1', 'p2'], [0.3, -1.2, 2.5]):
        assert mini.values[n] == pytest.approx(c, abs=1e-9)
    cov = 2.0 * np.linalg.inv(HESS3)
    for i, n in enumerate(['p0', 'p1', 'p2']):
        assert mini.errors[n] == pytest.approx(np.sqrt(cov[i, i]), rel=1e-8)
    assert mini.fmin.edm < 1e-12
    funcs, sample, _ = case('active_bound')
    mini = Minimizer(**funcs, sample_params=sample)
    mini.minimize()
    assert mini.values['p0'] == pytest.approx(1.0, abs=1e-12)
    assert mini.fmin.edm < 1e-12


def test_results_before_minimize_raise():
    funcs, sample, _ = case('no_hessian')
    mini = Minimizer(**funcs, sample_params=sample)
    with pytest.raises(RuntimeError, match='before minimization'):
        mini.values  # noqa: B018


def test_covariance_view():
    view = CovarianceView([[1.0, 2.0], [2.0, 5.0]], ['a', 'b'])
    assert view['a', 'b'] == 2.0 and view[1, 1] == 5.0
    assert view.to_dict() == {('a', 'a'): 1.0, ('a', 'b'): 2.0,
                              ('b', 'a'): 2.0, ('b', 'b'): 5.0}
    np.testing.assert_array_equal(np.array(view, dtype=np.float32),
                                  np.float32([[1, 2], [2, 5]]))


def test_minimizer_and_interface_import_without_jax():
    code = '''
import sys
sys.modules['jax'] = None
import vega_tpu_torch.vega_interface, vega_tpu_torch.minimizer
leaked = [m for m in sys.modules if m == 'vega_tpu' or m.startswith('vega_tpu.')]
assert not leaked, leaked
print('ok')
'''
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'
