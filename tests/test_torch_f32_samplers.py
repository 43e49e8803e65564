"""The f32 throughput mode (VEGA_TPU_X64=0 or dtype=torch.float32) of the
PyTorch port in the native samplers (samplers.nested: the slice evolution
and DeviceEvolve, the host loops; samplers.smc; samplers.hmc: one
trajectory, the hook's dtype, short runs; scripts/run_vega_sampler.py and
`cli sample`; examples/dr16_subset/bao_posterior_torch.py), on the CPU,
against the JAX package (vega_tpu) and the port's own f64.

- The host loops are numpy in both packages: on a numpy likelihood that
  returns f32, as vega_tpu's np.asarray of an f32 batch does under
  VEGA_TPU_X64=0, they are held to vega_tpu's bit for bit, their files
  and the arrays' dtypes too.
- The device evolution runs in the likelihood's dtype: held to a numpy
  transcription of vega_tpu's loop body in f32 on the same random numbers.
- One HMC trajectory is held to vega_tpu's f32 one on hand-fed random
  numbers (tests/data/torch_port_f32_campaign_goldens.json 'hmc_step',
  from a subprocess under VEGA_TPU_X64=0) to 1e-5 relative.
- Whole runs draw other random numbers in f32 than in f64: they are held
  to the f64 runs under vega_tpu's own gate for its f32 samplers
  (tests/test_bao_posterior_demo.py:121-124): |d mean| < sigma_64 + 1e-3
  and 0.6 < sigma_32 / sigma_64 < 1.67.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import importlib.util
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from vega_tpu.samplers.nested import NestedSampler as JaxNested
from vega_tpu.samplers.smc import SMCSampler as JaxSMC
from vega_tpu_torch import cli
from vega_tpu_torch import testing as port_testing
from vega_tpu_torch.parallel import BatchedLikelihood
from vega_tpu_torch.samplers import nested as tnested
from vega_tpu_torch.samplers.hmc import HMC, make_hmc_step
from vega_tpu_torch.samplers.nested import NestedSampler
from vega_tpu_torch.samplers.smc import SMCSampler
from vega_tpu_torch.scripts import run_vega_sampler
from vega_tpu_torch.testing import make_synthetic_dataset, with_control
from vega_tpu_torch.vega_interface import VegaInterface

from test_torch_f32_path import F64Ops

REPO = Path(__file__).resolve().parents[1]
GOLDENS = json.loads((Path(__file__).parent / 'data'
                      / 'torch_port_f32_campaign_goldens.json').read_text())
LIMITS = {'x': (-5.0, 5.0), 'y': (-5.0, 5.0)}
AUTO_LIMITS = {'bias_LYA': (-0.3, -0.01), 'beta_LYA': (0.5, 3.0)}
F32_ATOL = 1e-6         # f32 arithmetic of two packages, unit-cube values
HMC_RTOL = 1e-5         # one f32 trajectory against vega_tpu's


def posterior_gate(got, want):
    """vega_tpu's gate for its f32 samplers: (mean, sigma) of each run."""
    (mean32, std32), (mean64, std64) = got, want
    return bool(np.all(np.abs(mean32 - mean64) < std64 + 1e-3)
                and np.all((0.6 < std32 / std64) & (std32 / std64 < 1.67)))


def moments(result):
    weights = result.get('weights')
    if weights is None:
        weights = np.ones(len(result['samples']))
    mean = np.average(result['samples'], axis=0, weights=weights)
    return mean, np.sqrt(np.average((result['samples'] - mean) ** 2,
                                    axis=0, weights=weights))


def gaussian_loglik_f32(params):
    """tests/test_samplers.py's N(0, 1) per dimension, returned in f32 as
    vega_tpu's np.asarray of an f32 likelihood batch is."""
    x = np.asarray(params['x'])
    y = np.asarray(params['y'])
    return (-0.5 * (x ** 2 + y ** 2) - np.log(2 * np.pi)).astype(np.float32)


def section(path, name='gauss', header='sampler', **options):
    path.mkdir(parents=True, exist_ok=True)
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config[header] = {'path': str(path), 'name': name,
                      **{k: str(v) for k, v in options.items()}}
    return config[header]


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_X64', raising=False)
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        mp.delenv('VEGA_TPU_NS_DEVICE_LOOP', raising=False)
        yield mp


# ----------------------------------------------------------------------
# The host loops on an f32 likelihood, bit for bit
# ----------------------------------------------------------------------
def assert_same_run(got, want, got_dir, want_dir, name='gauss',
                    state=None):
    """Results, their dtypes and the written files equal; `state` names
    the checkpoint whose arrays (dtypes included) must be equal."""
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    for suffix in ('.txt', '.paramnames', '.stats'):
        assert ((got_dir / (name + suffix)).read_text()
                == (want_dir / (name + suffix)).read_text()), suffix
    if state is not None:
        a, b = (dict(np.load(d / (name + state))) for d in (got_dir,
                                                            want_dir))
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert a[key].dtype == b[key].dtype, key


@pytest.mark.parametrize('proposal', ['slice', 'rwm'])
def test_nested_host_loop_on_f32_equals_jax(tmp_path, proposal):
    """The same seed and an f32 numpy likelihood: samples, weights,
    log-likelihoods, logZ and its error, the chain, .paramnames, .stats
    and the resume file equal vega_tpu's, bit for bit and dtype for
    dtype (the live log-likelihoods stay f32 in both)."""
    options = dict(num_live=100, num_repeats=6, precision=0.05,
                   resume=False, seed=3, proposal=proposal)
    want = JaxNested(section(tmp_path / 'jax', **options), LIMITS,
                     gaussian_loglik_f32).run()
    got = NestedSampler(section(tmp_path / 'port', **options), LIMITS,
                        gaussian_loglik_f32).run()
    assert_same_run(got, want, tmp_path / 'port', tmp_path / 'jax',
                    state='.resume.npz')
    live = np.load(tmp_path / 'port' / 'gauss.resume.npz')['live_logl']
    assert live.dtype == np.float32
    assert abs(got['logz'] + np.log(100.0)) < 0.5


def test_smc_on_f32_equals_jax(tmp_path):
    options = dict(n_effective=300, n_mcmc=4, resume=False, seed=5)
    want = JaxSMC(section(tmp_path / 'jax', **options), LIMITS,
                  gaussian_loglik_f32).run()
    got = SMCSampler(section(tmp_path / 'port', **options), LIMITS,
                     gaussian_loglik_f32).run()
    assert_same_run(got, want, tmp_path / 'port', tmp_path / 'jax',
                    state='.smc.npz')
    assert got['loglikes'].dtype == np.float32
    assert abs(got['logz'] + np.log(100.0)) < 0.5


# ----------------------------------------------------------------------
# The slice evolution and DeviceEvolve in f32
# ----------------------------------------------------------------------
def numpy_slice_evolve(log_lik_u, u0, l_min, width, chol, normals, offsets,
                       shrinks):
    """vega_tpu/samplers/nested.py:212-254 in numpy, in the arrays'
    dtype (f32 arrays and Python scalars stay f32), with the random
    numbers fed in where it splits keys."""
    n = u0.shape[0]
    u, logl = u0.copy(), log_lik_u(u0)
    steps = moves = 0
    for r in range(normals.shape[0]):
        d = normals[r] @ chol.T
        left = -width * offsets[r]
        right = left + width
        done = np.zeros(n, dtype=bool)
        for s in range(shrinks.shape[1]):
            t = left + (right - left) * shrinks[r, s]
            t = np.where(done, u0.dtype.type(0.0), t)
            prop = u + t[:, None] * d
            inside = np.all((prop > 0) & (prop < 1), axis=1)
            prop_c = np.clip(prop, 1e-12, 1 - 1e-12)
            logl_prop = log_lik_u(prop_c)
            ok = inside & (logl_prop > l_min) & ~done
            u = np.where(ok[:, None], prop, u)
            logl = np.where(ok, logl_prop, logl)
            steps += int(np.sum(~done))
            done = done | ok
            rej = ~done
            left = np.where(rej & (t < 0), t, left)
            right = np.where(rej & (t >= 0), t, right)
        moves += int(np.sum(done))
    return u, logl, steps, moves


def test_slice_evolve_f32_equals_the_numpy_transcription():
    """Hand-fed f32 random numbers, the toy Gaussian on [-5, 5]^2: u
    within F32_ATOL, logl within 1e-6 relative, steps and moves equal;
    the clamp's 1 - 1e-12 is 1.0 in f32 on both sides."""
    rng = np.random.default_rng(11)
    n, ndim, repeats, shrink = 25, 2, 4, 4
    f32 = np.float32
    u0 = rng.uniform(0.3, 0.7, (n, ndim)).astype(f32)
    chol = np.linalg.cholesky(np.cov(rng.uniform(size=(100, ndim)),
                                     rowvar=False)).astype(f32)
    randoms = tuple(r.astype(f32) for r in (
        rng.standard_normal((repeats, n, ndim)),
        rng.uniform(size=(repeats, n)), rng.uniform(size=(repeats, shrink,
                                                          n))))
    assert f32(1 - 1e-12) == 1.0

    def log_lik_np(u):
        x = -5.0 + 10.0 * u
        return -0.5 * np.sum(x ** 2, axis=1) - f32(np.log(2 * np.pi))

    def log_lik_torch(u):
        x = -5.0 + 10.0 * u
        return -0.5 * torch.sum(x ** 2, dim=1) - float(f32(np.log(2 * np.pi)))

    want = numpy_slice_evolve(log_lik_np, u0, f32(-2.0), f32(2.0), chol,
                              *randoms)
    got = tnested.slice_evolve(
        log_lik_torch, torch.as_tensor(u0), torch.tensor(-2.0),
        torch.tensor(2.0), torch.as_tensor(chol),
        *(torch.as_tensor(r) for r in randoms))
    assert want[0].dtype == want[1].dtype == np.float32
    assert got[0].dtype == got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6)
    assert (int(got[2]), int(got[3])) == want[2:]
    assert 0 < want[3] < repeats * n and want[2] > want[3]


@pytest.fixture(scope='module')
def auto(tmp_path_factory):
    """tests/test_samplers.py's tiny auto dataset (noise = 1), written by
    the port; its f32 and f64 interfaces."""
    tmp = tmp_path_factory.mktemp('auto32')
    main = make_synthetic_dataset(tmp, cross=False, size='tiny', noise=1.0,
                                  device='cpu')
    return {'main': main, 'tmp': tmp,
            torch.float32: VegaInterface(main, device='cpu',
                                         dtype=torch.float32),
            torch.float64: VegaInterface(main, device='cpu',
                                         dtype=torch.float64)}


def test_device_evolve_f32_makes_no_host_sync(auto, monkeypatch):
    """DeviceEvolve on an f32 likelihood: its buffers, random numbers and
    packed results are f32; run() with every host read of a tensor
    patched to raise, and with no float64 tensor made; its results equal
    the f32 numpy transcription driven by the port's f32 log_lik_batch
    (logl 1e-6 relative: the same function evaluated in other batches);
    the sampler's call returns f32 arrays as vega_tpu's evolve does."""
    vega = auto[torch.float32]
    names = list(AUTO_LIMITS)
    evolve = tnested.DeviceEvolve(BatchedLikelihood(vega), names,
                                  AUTO_LIMITS, 10, 3, 4, seed=5)
    assert evolve.graph is None
    assert all(t.dtype == torch.float32
               for t in (*evolve.inputs, *evolve.randoms, evolve._host_in))
    rng = np.random.default_rng(4)
    start = rng.uniform(0.35, 0.45, (10, 2))
    chol = 0.02 * np.eye(2)
    lo = np.array([AUTO_LIMITS[n][0] for n in names], dtype=np.float32)
    span = np.array([AUTO_LIMITS[n][1] for n in names],
                    dtype=np.float32) - lo

    def log_lik_np(u):
        theta = lo + u * span
        return vega.log_lik_batch(
            {name: theta[:, i] for i, name in enumerate(names)}).numpy()

    l_min = float(np.median(log_lik_np(start.astype(np.float32))))
    evolve.load(start, l_min, 2.0, chol)
    evolve.draw(9)
    randoms = [r.numpy().copy() for r in evolve.randoms]

    def refuse(*args, **kwargs):
        raise AssertionError('host sync inside the device evolve')

    with monkeypatch.context() as mp, F64Ops() as ops:
        for method in ('item', 'cpu', 'tolist', 'numpy', '__bool__',
                       '__float__', '__int__', '__index__'):
            mp.setattr(torch.Tensor, method, refuse)
        out = evolve.run()
    assert ops.seen == {}
    assert out.dtype == torch.float32
    out = out.numpy()
    want = numpy_slice_evolve(
        log_lik_np, start.astype(np.float32), np.float32(l_min),
        np.float32(2.0), chol.astype(np.float32), *randoms)
    np.testing.assert_allclose(out[:20].reshape(10, 2), want[0], rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(out[20:30], want[1], rtol=1e-6)
    assert (int(out[30]), int(out[31])) == want[2:]
    u, logl, steps, moves = evolve(start, l_min, 2.0, chol, 9)
    assert u.dtype == logl.dtype == np.float32
    np.testing.assert_array_equal(logl, out[20:30])
    assert (steps, moves) == want[2:]


def test_nested_device_loop_f32_matches_the_host_loops(auto):
    """tests/test_torch_samplers.py's run (num_live 100, num_repeats 6,
    precision 0.05, seed 7) by the f32 device loop and the f32 host loop,
    each against the f64 host loop under vega_tpu's gate, and logZ within
    3 max(errors, 0.1); the f32 host loop's live log-likelihoods f32."""
    runs = {}
    for label, dtype, device_loop in (('device32', torch.float32, True),
                                      ('host32', torch.float32, False),
                                      ('host64', torch.float64, False)):
        out = auto['tmp'] / f'out_{label}'
        sampler = NestedSampler(section(out, name=label, num_live=100,
                                        num_repeats=6, precision=0.05,
                                        resume=False, seed=7,
                                        device_loop=device_loop),
                                AUTO_LIMITS, BatchedLikelihood(auto[dtype]))
        runs[label] = sampler.run()
        assert np.isfinite(np.loadtxt(out / f'{label}.txt')).all()
    live = np.load(auto['tmp'] / 'out_host32' / 'host32.resume.npz')
    assert live['live_logl'].dtype == np.float32
    for label in ('device32', 'host32'):
        got, want = runs[label], runs['host64']
        assert abs(got['logz'] - want['logz']) <= 3.0 * max(
            got['logz_err'], want['logz_err'], 0.1), label
        assert posterior_gate(moments(got), moments(want)), label


# ----------------------------------------------------------------------
# HMC in f32
# ----------------------------------------------------------------------
TOY_LIMITS = {'a': (-2.0, 3.0), 'b': (0.0, 4.0), 'c': (-1.0, 1.0)}


def toy_chi2_f32(x):
    """tests/test_torch_hmc.py's quadratic plus quartic toy in f32."""
    mu = torch.tensor([0.4, 1.7, -0.2], dtype=torch.float32)
    a = torch.tensor([[3.0, 0.8, -0.4], [0.8, 2.0, 0.3], [-0.4, 0.3, 5.0]],
                     dtype=torch.float32)
    d = x - mu
    return torch.sum(d * (d @ a.T), dim=-1) + 0.3 * torch.sum(d ** 4, dim=-1)


def test_hmc_step_f32_matches_jax_f32(tmp_path):
    """One trajectory of 5 leapfrog steps for 6 chains with a dense metric
    in f32, the momentum's normals and the acceptance uniform fed by hand
    to both packages: the potential and gradient at the start, then u,
    v, g and the mean acceptance within HMC_RTOL of their largest entry
    of vega_tpu's f32 trajectory, and the same chains accepted."""
    want = GOLDENS['tiny']['f32']['hmc_step']
    assert want['dtype'] == 'float32'
    sampler = HMC(section(tmp_path, name='hmc', header='HMC', num_chains=6,
                          num_leapfrog=want['n_leap']),
                  TOY_LIMITS, toy_chi2_f32, device='cpu',
                  dtype=torch.float32)
    assert sampler.dtype == torch.float32

    def f32(values):
        return torch.tensor(values, dtype=torch.float32)

    pot_vg = sampler._build_potential()
    u0 = f32(want['u0'])
    v0, g0 = pot_vg(u0)
    step = make_hmc_step(pot_vg, want['n_leap'])
    chains = u0.shape[0]
    u, v, g, alpha = step(
        f32(want['z']).expand(chains, -1),
        torch.log(f32(want['uniform'])).expand(chains), u0, v0, g0,
        f32(want['eps']), f32(want['inv_mass']), f32(want['chol_mass']))
    for got, ref in ((v0, want['v0']), (g0, want['g0']), (u, want['u']),
                     (v, want['v']), (g, want['g']),
                     (alpha.mean(), want['accept_mean'])):
        assert got.dtype == torch.float32
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) <= HMC_RTOL * np.max(
            np.abs(ref))
    moved = np.any(u.numpy() != np.asarray(want['u0'], np.float32), axis=1)
    np.testing.assert_array_equal(moved, np.any(
        np.asarray(want['u']) != np.asarray(want['u0'], np.float32), axis=1))
    assert 0 < moved.sum() < chains


def test_hmc_dtype_follows_the_likelihood(auto, tmp_path, env):
    """The interface's dtype, else for the hook its `dtype` argument, else
    VEGA_TPU_X64 as VegaInterface reads it."""
    for dtype in (torch.float32, torch.float64):
        sampler = HMC(section(tmp_path / 'a', header='HMC'), AUTO_LIMITS,
                      BatchedLikelihood(auto[dtype]))
        assert sampler.dtype == dtype
    hook = HMC(section(tmp_path / 'b', header='HMC'), TOY_LIMITS,
               toy_chi2_f32, device='cpu')
    assert hook.dtype == torch.float64
    env.setenv('VEGA_TPU_X64', '0')
    hook = HMC(section(tmp_path / 'b', header='HMC'), TOY_LIMITS,
               toy_chi2_f32, device='cpu')
    assert hook.dtype == torch.float32
    hook = HMC(section(tmp_path / 'b', header='HMC'), TOY_LIMITS,
               toy_chi2_f32, device='cpu', dtype=torch.float64)
    assert hook.dtype == torch.float64
    env.delenv('VEGA_TPU_X64')


def test_hmc_f32_run_matches_f64_and_makes_no_f64_tensor(auto, tmp_path):
    """A short HMC run (8 chains, 60 + 60 trajectories of 8 leapfrog
    steps) on the f32 and the f64 interface of the tiny auto dataset:
    the f32 draws f32, acceptance in (0.4, 1], the posterior under
    vega_tpu's gate against f64's; one f32 trajectory makes no float64
    tensor."""
    results = {}
    for dtype in (torch.float32, torch.float64):
        sampler = HMC(section(tmp_path / str(dtype), header='HMC',
                              num_chains=8, num_samples=60, num_warmup=60,
                              num_leapfrog=8, seed=3),
                      AUTO_LIMITS, BatchedLikelihood(auto[dtype]))
        results[dtype] = sampler.run()
        assert 0.4 < results[dtype]['accept_rate'] <= 1.0
        assert np.isfinite(results[dtype]['samples']).all()
    assert results[torch.float32]['logp'].dtype == np.float32
    assert posterior_gate(moments(results[torch.float32]),
                          moments(results[torch.float64]))
    sampler = HMC(section(tmp_path / 'step', header='HMC', num_leapfrog=2),
                  AUTO_LIMITS, BatchedLikelihood(auto[torch.float32]))
    pot_vg = sampler._build_potential()
    u = torch.zeros((4, 2), dtype=torch.float32)
    eye = torch.eye(2, dtype=torch.float32)
    with torch.no_grad():
        v, g = pot_vg(u)
        with F64Ops() as ops:
            make_hmc_step(pot_vg, 2)(torch.ones_like(u), torch.zeros(4), u,
                                     v, g, torch.tensor(0.1), eye, eye)
    assert ops.seen == {}


# ----------------------------------------------------------------------
# The sampler script and the BAO posterior demo under VEGA_TPU_X64=0
# ----------------------------------------------------------------------
@pytest.mark.parametrize('name,section_text,entry', [
    ('NestedJax', 'num_live = 50\nnum_repeats = 5\nprecision = 0.1\n'
                  'resume = False\nmax_iters = 150\n', 'script'),
    ('PocoMC', 'n_effective = 64\nn_mcmc = 2\nresume = False\n', 'cli'),
    ('HMC', 'num_chains = 8\nnum_samples = 30\nnum_warmup = 30\n'
            'num_leapfrog = 8\nseed = 3\n', 'script'),
])
def test_run_vega_sampler_in_f32(auto, env, name, section_text, entry):
    """run_vega_sampler (or `cli sample`) under VEGA_TPU_X64=0 --device
    cpu with each native sampler: it ends, on an f32 interface, and its
    chain reads back finite inside the limits; NS and SMC's -2 ln L column
    is -2 log_lik_batch of the f32 interface at its points (1e-6
    relative: f32 values written through f64)."""
    out_dir = auto['tmp'] / f'script_{name}'
    out_dir.mkdir()
    main = with_control(
        auto['main'], f'run_sampler = True\nsampler = {name}\n',
        auto['tmp'] / f'main_{name}.ini',
        f'\n[{name}]\npath = {out_dir}\nname = synth\n' + section_text)
    env.setenv('VEGA_TPU_X64', '0')
    if entry == 'cli':
        assert cli.main(['sample', str(main), '--device', 'cpu']) == 0
        vega = VegaInterface(main, device='cpu')
    else:
        vega, _, _ = run_vega_sampler.run([str(main), '--device', 'cpu'])
    env.delenv('VEGA_TPU_X64')
    assert vega.dtype == torch.float32
    chain = np.loadtxt(out_dir / 'synth.txt')
    assert chain.shape[1] == 4 and np.isfinite(chain).all()
    lo, hi = np.array(list(vega.sample_params['limits'].values())).T
    assert np.all((chain[:, 2:] >= lo) & (chain[:, 2:] <= hi))
    if name != 'HMC':
        want = -2.0 * vega.log_lik_batch(
            {'bias_LYA': chain[:, 2], 'beta_LYA': chain[:, 3]}).numpy()
        np.testing.assert_allclose(chain[:, 1], want, rtol=1e-6)


@pytest.fixture(scope='module')
def demo():
    path = REPO / 'examples' / 'dr16_subset' / 'bao_posterior_torch.py'
    spec = importlib.util.spec_from_file_location('bao_posterior_torch', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bao_posterior_demo_f32_reproduces_f64(demo, tmp_path, monkeypatch,
                                               capsys):
    """examples/dr16_subset/bao_posterior_torch.py at the tiny size (8 x 8
    grid nodes) with 32 live points, 16 replaced per iteration, in f64
    and under VEGA_TPU_X64=0: the f32 posterior of (ap, at, bias_LYA,
    beta_LYA) within vega_tpu's gate of the f64 one, both printed with
    their precision; --dataset dr16 without VEGA_REFERENCE, or without
    the checkout it names, fails as vega_tpu's demo does without its
    checkout; with no --workdir the files go to a new directory under the
    temporary directory."""
    build = port_testing.make_synthetic_dataset

    def tiny(*args, **kwargs):
        return build(*args, size='tiny',
                     extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n',
                     **kwargs)

    monkeypatch.setattr(port_testing, 'make_synthetic_dataset', tiny)
    argv = ['--device', 'cpu', '--num-live', '32', '--batch-size', '16',
            '--precision', '0.3']
    runs = {}
    for label, x64 in (('f64', None), ('f32', '0')):
        if x64 is not None:
            monkeypatch.setenv('VEGA_TPU_X64', x64)
        runs[label] = demo.main(argv + ['--workdir', str(tmp_path / label)])
        assert f', {label}, cpu) ===' in capsys.readouterr().out
    monkeypatch.delenv('VEGA_TPU_X64')
    assert posterior_gate(moments(runs['f32']), moments(runs['f64']))
    monkeypatch.delenv('VEGA_REFERENCE', raising=False)
    with pytest.raises(KeyError):
        demo.main(['--dataset', 'dr16', '--device', 'cpu', '--workdir',
                   str(tmp_path / 'dr16')])
    monkeypatch.setenv('VEGA_REFERENCE', str(tmp_path / 'no_reference'))
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path / 'tmp'))
    (tmp_path / 'tmp').mkdir()
    with pytest.raises(KeyError):
        demo.main(['--dataset', 'dr16', '--device', 'cpu'])
    assert [p.name[:15] for p in (tmp_path / 'tmp').iterdir()] \
        == ['bao_demo_torch_']
