"""The exact-gradient HMC of the PyTorch port
(vega_tpu_torch.samplers.hmc, the gradient-only form of
VegaInterface.chi2_batch_derivatives, scripts/run_vega_sampler.py with an
[HMC] section) against the JAX package (vega_tpu), on the CPU.

The port draws its momenta and acceptance uniforms from a torch
generator, vega_tpu from jax.random: one trajectory is compared with
hand-fed random numbers (vega_tpu's draws patched to return them), whole
runs on their diagnostics.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu.gridcollapse as jgc
from vega_tpu.samplers.hmc import HMC as JaxHMC
from vega_tpu.statics import STATICS
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.parallel import BatchedLikelihood
from vega_tpu_torch.samplers.hmc import HMC, make_hmc_step
from vega_tpu_torch.scripts import run_vega_sampler
from vega_tpu_torch.vega_interface import VegaInterface

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
NUISANCE = ('bias_LYA', 'beta_LYA')
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
ROWS = np.array([[1.03, 0.97, -0.12, 1.6], [0.9, 1.1, -0.11, 1.75],
                 [1.18, 0.85, -0.125, 1.52], [1.0, 1.0, -0.117, 1.67],
                 [0.95, 1.05, -0.119, 1.7]])
# gradient-only call against the full call (the same graph, one backward
# pass each) and against vmapped jax.grad (f64 both sides, sums ordered
# differently: tests/test_torch_analysis.py's tolerances)
FULL_RTOL = 1e-13
JAX_RTOL = {'grid_payload': 1e-9, 'nuisance': 1e-9, 'dense': 1e-9}
STEP_ATOL = 1e-10       # one trajectory against vega_tpu's


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def section(path, name='hmc', **options):
    path.mkdir(parents=True, exist_ok=True)
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['HMC'] = {'path': str(path), 'name': name,
                     **{k: str(v) for k, v in options.items()}}
    return config['HMC']


@pytest.fixture(scope='module')
def cross(tmp_path_factory):
    """vega_tpu and port interfaces on one tiny auto+cross dataset with
    noise, (ap, at, bias_LYA, beta_LYA) sampled, 8 x 8 grid nodes, the
    port serving vega_tpu's payload; and a dense port."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        tmp = tmp_path_factory.mktemp('hmc')
        main = jax_make_dataset(
            tmp, cross=True, size='tiny', sample=SAMPLE, seed=3, noise=1.0,
            extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n'
                          'ds-matmul = False')
        jax_vega = JaxInterface(main)
        jgc.save_payload(tmp / 'payload.npz', jax_vega.get_collapsed(NAMES))
        port = VegaInterface(main, device='cpu')
        port.use_grid_payload(NAMES, gc.load_payload(tmp / 'payload.npz'))
        with pytest.MonkeyPatch.context() as dense_mp:
            dense_mp.setenv('VEGA_TPU_FACTORED', '0')
            dense = VegaInterface(main, device='cpu')
        yield {'main': main, 'tmp': tmp, 'jax': jax_vega, 'port': port,
               'dense': dense}


# ----------------------------------------------------------------------
# (e) the gradient-only derivatives
# ----------------------------------------------------------------------
def jax_value_and_gradient(jax_vega, names, rows):
    """chi^2 and jax.vmap(jax.grad) of vega_tpu's _chi2_graph_bound."""
    jax_vega._ensure_static_refs()
    data_vecs = {k: jnp.asarray(v)
                 for k, v in jax_vega._current_data_vecs().items()}
    cov_scales = jax_vega._current_cov_scales()
    collapsed = jax_vega._device_collapsed(jax_vega.get_collapsed(names))
    statics = STATICS.device_tree()

    def f(x):
        return jax_vega._chi2_graph_bound(
            dict(zip(names, x)), data_vecs, cov_scales, statics,
            collapsed)[0]

    x = jnp.asarray(rows)
    return [np.asarray(jax.jit(jax.vmap(fn))(x)) for fn in (f, jax.grad(f))]


@pytest.mark.parametrize('regime', list(JAX_RTOL))
def test_gradient_only_derivatives(cross, monkeypatch, regime):
    """chi2_batch_derivatives(..., hessian=False) gives the full call's
    value and gradient (FULL_RTOL) and no Hessian, builds no graph, and
    agrees with vmapped jax.grad of vega_tpu's chi^2 (JAX_RTOL)."""
    names = list(NUISANCE if regime == 'nuisance' else NAMES)
    rows = ROWS[:, 2:] if regime == 'nuisance' else ROWS
    port = cross['dense' if regime == 'dense' else 'port']
    jax_vega = cross['jax']
    if regime == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')   # vega_tpu: at trace
        jax_vega = JaxInterface(cross['main'])
    chi2, grad, hess = port.chi2_batch_derivatives(names, rows,
                                                   hessian=False)
    assert hess is None
    assert chi2.shape == (5,) and grad.shape == (5, len(names))
    assert not chi2.requires_grad and not grad.requires_grad
    full = port.chi2_batch_derivatives(names, rows)
    assert max_rel(chi2.numpy(), full[0].numpy()) <= FULL_RTOL
    assert max_rel(grad.numpy(), full[1].numpy()) <= FULL_RTOL
    assert full[2].shape == (5, len(names), len(names))
    want = jax_value_and_gradient(jax_vega, names, rows)
    for i in range(len(rows)):
        assert max_rel(chi2[i].numpy(), want[0][i]) <= JAX_RTOL[regime]
        assert max_rel(grad[i].numpy(), want[1][i]) <= JAX_RTOL[regime]


def test_gradient_only_with_no_free_name(cross):
    chi2, grad, hess = cross['port'].chi2_batch_derivatives(
        [], np.zeros((3, 0)), fixed={'bias_LYA': [-0.12, -0.11, -0.1]},
        hessian=False)
    assert chi2.shape == (3,) and grad.shape == (3, 0) and hess is None


# ----------------------------------------------------------------------
# (f) one trajectory, the run and the diagnostics
# ----------------------------------------------------------------------
TOY_LIMITS = {'a': (-2.0, 3.0), 'b': (0.0, 4.0), 'c': (-1.0, 1.0)}
TOY_MU = np.array([0.4, 1.7, -0.2])
TOY_A = np.array([[3.0, 0.8, -0.4], [0.8, 2.0, 0.3], [-0.4, 0.3, 5.0]])


def toy_chi2_jax(x):
    """Quadratic plus quartic, one point."""
    d = x - TOY_MU
    return d @ (jnp.asarray(TOY_A) @ d) + 0.3 * jnp.sum(d ** 4)


def toy_chi2_torch(x):
    """The same over a (chains, ndim) tensor."""
    d = x - torch.as_tensor(TOY_MU)
    return (torch.sum(d * (d @ torch.as_tensor(TOY_A).T), dim=-1)
            + 0.3 * torch.sum(d ** 4, dim=-1))


def test_hmc_step_matches_jax(tmp_path, monkeypatch):
    """One trajectory of 5 leapfrog steps for 6 chains with a dense
    metric, the momentum's normals and the acceptance uniform fed by hand
    (vega_tpu's jax.random draws patched to return them): u, v, g within
    STEP_ATOL, the acceptance probabilities too, the same chains
    accepted, and both outcomes present."""
    rng = np.random.default_rng(8)
    n_chains, ndim, n_leap, eps = 6, 3, 5, 0.65
    u0 = rng.normal(size=(n_chains, ndim))
    z = rng.normal(size=ndim)
    uniform = 0.45
    m = rng.normal(size=(ndim, ndim))
    inv_mass = m @ m.T / ndim + 0.5 * np.eye(ndim)
    chol_mass = np.linalg.cholesky(np.linalg.inv(inv_mass))
    options = dict(num_chains=n_chains, num_leapfrog=n_leap)

    jax_sampler = JaxHMC(section(tmp_path / 'jax', **options), TOY_LIMITS,
                         toy_chi2_jax)
    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape=(), dtype=float: jnp.asarray(z))
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda key, *a, **k: jnp.asarray(uniform))
    run_block, init_chains = jax_sampler._build_scan()
    v0, g0 = init_chains(jnp.asarray(u0))
    log_eps = jnp.asarray(np.log(eps))
    carry, us, vs, accs = run_block(
        jax.random.PRNGKey(0), (jnp.asarray(u0), v0, g0),
        jnp.asarray(inv_mass), jnp.asarray(chol_mass), 1, False, log_eps,
        (jnp.asarray(0.0), log_eps, log_eps))
    want_u, want_v, want_g = (np.asarray(x) for x in carry[1])

    sampler = HMC(section(tmp_path / 'port', **options), TOY_LIMITS,
                  toy_chi2_torch, device='cpu')
    pot_vg = sampler._build_potential()
    got_v0, got_g0 = pot_vg(torch.as_tensor(u0))
    np.testing.assert_allclose(got_v0.numpy(), np.asarray(v0), rtol=0,
                               atol=STEP_ATOL)
    np.testing.assert_allclose(got_g0.numpy(), np.asarray(g0), rtol=0,
                               atol=STEP_ATOL)
    step = make_hmc_step(pot_vg, n_leap)
    u, v, g, alpha = step(
        torch.as_tensor(np.tile(z, (n_chains, 1))),
        torch.full((n_chains,), np.log(uniform), dtype=torch.float64),
        torch.as_tensor(u0), got_v0, got_g0,
        torch.tensor(eps, dtype=torch.float64), torch.as_tensor(inv_mass),
        torch.as_tensor(chol_mass))
    np.testing.assert_allclose(u.numpy(), want_u, rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(alpha.mean().numpy(), np.asarray(accs)[0],
                               rtol=0, atol=STEP_ATOL)
    moved = np.any(u.numpy() != u0, axis=1)
    np.testing.assert_array_equal(moved, np.any(want_u != u0, axis=1))
    np.testing.assert_array_equal(moved, alpha.numpy() > uniform)
    assert 0 < moved.sum() < n_chains


def test_hmc_dual_averaging_matches_jax(tmp_path, monkeypatch):
    """Two warm-up blocks of 3 adapting trajectories each, the second
    started from the first's averaged step as run() does, on hand-fed
    random numbers (the draws of both packages patched to return them):
    the step size, the dual-averaging state (h_bar, log_eps_bar), the
    chains and the mean acceptances within STEP_ATOL of vega_tpu's
    run_block."""
    rng = np.random.default_rng(11)
    n_chains, ndim, n_leap, n_iters = 6, 3, 4, 3
    u0 = 0.5 * rng.normal(size=(n_chains, ndim))
    z = rng.normal(size=ndim)
    uniform = 0.6
    options = dict(num_chains=n_chains, num_leapfrog=n_leap,
                   target_accept=0.7)
    log_eps0 = np.log(0.4)

    jax_sampler = JaxHMC(section(tmp_path / 'jax', **options), TOY_LIMITS,
                         toy_chi2_jax)
    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape=(), dtype=float: jnp.asarray(z))
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda key, *a, **k: jnp.asarray(uniform))
    run_block, init_chains = jax_sampler._build_scan()
    v0, g0 = init_chains(jnp.asarray(u0))
    eye = np.eye(ndim)
    want, state, log_eps = [], (jnp.asarray(u0), v0, g0), jnp.asarray(log_eps0)
    for _ in range(2):
        carry, us, vs, accs = run_block(
            jax.random.PRNGKey(0), state, jnp.asarray(eye), jnp.asarray(eye),
            n_iters, True, log_eps,
            (jnp.asarray(0.0), log_eps, log_eps + jnp.log(10.0)))
        want.append((carry, us, accs))
        state, (_, log_eps, _) = carry[1], carry[3]

    sampler = HMC(section(tmp_path / 'port', **options), TOY_LIMITS,
                  toy_chi2_torch, device='cpu')
    monkeypatch.setattr(
        torch, 'randn', lambda shape, **k: torch.as_tensor(z).expand(shape))
    monkeypatch.setattr(
        torch, 'rand',
        lambda shape, **k: torch.full(shape, uniform, dtype=torch.float64))
    pot_vg = sampler._build_potential()
    step = make_hmc_step(pot_vg, n_leap)
    u = torch.as_tensor(u0)
    state = (u, *pot_vg(u))
    log_eps = torch.tensor(log_eps0, dtype=torch.float64)
    eye = torch.as_tensor(eye)
    for want_carry, want_us, want_accs in want:
        carry, us, _, accs = sampler._run_block(
            step, None, state, eye, eye, n_iters, True, log_eps,
            (torch.zeros((), dtype=torch.float64), log_eps,
             log_eps + np.log(10.0)))
        state, last_log_eps, (h_bar, log_eps_bar, mu) = carry
        for got, wanted in ((last_log_eps, want_carry[2]),
                            (h_bar, want_carry[3][0]),
                            (log_eps_bar, want_carry[3][1]),
                            (mu, want_carry[3][2]), (us, want_us),
                            (accs, want_accs), (state[1], want_carry[1][1]),
                            (state[2], want_carry[1][2])):
            np.testing.assert_allclose(got.numpy(), np.asarray(wanted),
                                       rtol=0, atol=STEP_ATOL)
        log_eps = log_eps_bar
    # the step size moved, and some trajectories were rejected
    assert abs(float(log_eps) - log_eps0) > 0.05
    assert np.any(np.asarray(want[0][2]) < 1.0)


def test_hmc_standalone_hook_runs_on_the_card_unless_told(tmp_path):
    """The plain-callable hook is an entry point like the others: with no
    `device` it asks for the card, and raises where there is none instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        sampler = HMC(section(tmp_path), TOY_LIMITS, toy_chi2_torch)
        assert sampler.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            HMC(section(tmp_path), TOY_LIMITS, toy_chi2_torch)
    assert HMC(section(tmp_path), TOY_LIMITS, toy_chi2_torch,
               device='cpu').device == torch.device('cpu')


def test_hmc_rejects_a_non_finite_trajectory(tmp_path):
    """A trajectory that ends on a non-finite potential is rejected
    (log_alpha -> -inf), and the chain keeps its state."""
    def pot_vg(u):
        return (torch.full((u.shape[0],), float('nan'), dtype=u.dtype),
                torch.zeros_like(u))

    step = make_hmc_step(pot_vg, 2)
    u0 = torch.zeros((3, 2), dtype=torch.float64)
    v0 = torch.ones(3, dtype=torch.float64)
    eye = torch.eye(2, dtype=torch.float64)
    u, v, g, alpha = step(torch.ones_like(u0), torch.full_like(v0, -50.0),
                          u0, v0, torch.zeros_like(u0),
                          torch.tensor(0.1, dtype=torch.float64), eye, eye)
    assert torch.equal(u, u0) and torch.equal(v, v0)
    assert torch.equal(alpha, torch.zeros_like(alpha))


def test_hmc_samples_the_toy_posterior(tmp_path):
    """The standalone hook end to end: the toy's mean recovered within
    0.15 (its sigmas are 0.3-0.5), acceptance in (0.5, 1], R-hat < 1.1."""
    sampler = HMC(section(tmp_path, num_chains=16, num_samples=300,
                          num_warmup=200, num_leapfrog=8, seed=1),
                  TOY_LIMITS, toy_chi2_torch, device='cpu')
    result = sampler.run()
    assert result['samples'].shape == (16 * 300, 3)
    assert 0.5 < result['accept_rate'] <= 1.0
    assert np.max(result['r_hat']) < 1.1
    assert np.all(np.abs(result['samples'].mean(axis=0) - TOY_MU) < 0.15)
    chain = np.loadtxt(tmp_path / 'hmc.txt')
    assert chain.shape == (16 * 300, 5) and np.all(chain[:, 0] == 1.0)
    np.testing.assert_allclose(chain[:, 1], -2 * result['logp'], rtol=1e-12)


@pytest.mark.parametrize('regime', ['grid_payload', 'dense'])
def test_hmc_short_run_on_the_cross_config(cross, regime):
    """8 chains, 60 + 60 trajectories of 8 leapfrog steps
    (the sizes of vega_tpu's own HMC script test; 4 chains and 20 + 20 on
    the dense path) on the tiny auto+cross configuration with (ap, at,
    bias_LYA, beta_LYA) sampled: chain shape, finiteness, the limits,
    acceptance in (0.4, 1]."""
    port = cross['dense' if regime == 'dense' else 'port']
    chains, draws = (4, 20) if regime == 'dense' else (8, 60)
    out = cross['tmp'] / f'run_{regime}'
    sampler = HMC(section(out, num_chains=chains, num_samples=draws,
                          num_warmup=draws, num_leapfrog=8, seed=3),
                  port.sample_params['limits'], BatchedLikelihood(port))
    assert sampler._vega is port and sampler.device == port.device
    result = sampler.run()
    chain = np.loadtxt(out / 'hmc.txt')
    assert chain.shape == (chains * draws, 6)
    assert np.isfinite(chain).all()
    lo, hi = np.array(list(port.sample_params['limits'].values())).T
    assert np.all((chain[:, 2:] > lo) & (chain[:, 2:] < hi))
    assert 0.4 < result['accept_rate'] <= 1.0
    assert result['names'] == list(NAMES)
    # the chain's log-posterior column is the potential: chi^2 / 2 less
    # the log-Jacobian, up to the sign
    x = result['samples'][-3:]
    chi2 = port.chi2_batch(dict(zip(NAMES, x.T))).numpy()
    unit = (x - lo) / (hi - lo)
    log_jac = np.sum(np.log(hi - lo) + np.log(unit) + np.log1p(-unit),
                     axis=1)
    np.testing.assert_allclose(result['logp'][-3:], -(0.5 * chi2 - log_jac),
                               rtol=1e-9)


def test_hmc_diagnostics_equal_jax():
    rng = np.random.default_rng(6)
    chains = np.cumsum(rng.normal(size=(120, 5, 3)), axis=0) * 0.05 \
        + rng.normal(size=(120, 5, 3))
    np.testing.assert_array_equal(HMC._split_r_hat(chains),
                                  JaxHMC._split_r_hat(chains))
    np.testing.assert_array_equal(HMC._effective_sample_size(chains),
                                  JaxHMC._effective_sample_size(chains))


def test_hmc_takes_the_interface_or_the_batched_likelihood(cross):
    port = cross['port']
    limits = {n: port.sample_params['limits'][n] for n in NUISANCE}
    for handle in (port, BatchedLikelihood(port)):
        sampler = HMC(section(cross['tmp'] / 'handles'), limits, handle)
        assert sampler._vega is port and sampler._chi2_fn is None
    assert (cross['tmp'] / 'handles' / 'hmc.paramnames').read_text().split(
        )[::2] == list(NUISANCE)


# ----------------------------------------------------------------------
# (g) the script
# ----------------------------------------------------------------------
def test_run_vega_sampler_hmc(tmp_path):
    """The assertions of vega_tpu's own HMC script test, on the port's
    script."""
    out_dir = tmp_path / 'output_sampler'
    out_dir.mkdir()
    main_path = jax_make_dataset(tmp_path, cross=False, size='tiny',
                                 noise=1.0)
    text = main_path.read_text().replace(
        '[control]\n', '[control]\nrun_sampler = True\nsampler = HMC\n')
    text += (f'\n[HMC]\npath = {out_dir}\nname = synth_hmc\n'
             'num_chains = 8\nnum_samples = 60\nnum_warmup = 60\n'
             'num_leapfrog = 8\nseed = 3\n')
    main_path.write_text(text)
    assert run_vega_sampler.main([str(main_path), '--device', 'cpu']) == 0
    assert (out_dir / 'synth_hmc.paramnames').exists()
    chain = np.loadtxt(out_dir / 'synth_hmc.txt')
    assert chain.shape == (8 * 60, 4)  # weight, -2lnL, 2 params
    assert np.isfinite(chain).all()
