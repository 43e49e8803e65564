"""The native nested and SMC samplers of the PyTorch port
(vega_tpu_torch.samplers.nested / smc / polychord / pocomc, the traceable
log-likelihood of parallel.BatchedLikelihood, the sampler flags of
VegaInterface and scripts/run_vega_sampler.py) against the JAX package
(vega_tpu), on the CPU.

The host loops draw from numpy and are held to vega_tpu's bit for bit on
a plain numpy likelihood. The device loop draws from a torch generator
and is held to a numpy transcription of vega_tpu's loop bodies on hand-fed
random numbers, and to the host loops statistically.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu.gridcollapse as jgc
from vega_tpu.parallel import BatchedLikelihood as JaxBatched
from vega_tpu.samplers.nested import NestedSampler as JaxNested
from vega_tpu.samplers.smc import SMCSampler as JaxSMC
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.parallel import BatchedLikelihood
from vega_tpu_torch.samplers import nested as tnested
from vega_tpu_torch.samplers.nested import NestedSampler
from vega_tpu_torch.samplers.pocomc import PocoMC
from vega_tpu_torch.samplers.polychord import Polychord
from vega_tpu_torch.samplers.smc import SMCSampler
from vega_tpu_torch.scripts import run_vega_sampler
from vega_tpu_torch.testing import with_control
from vega_tpu_torch.vega_interface import VegaInterface

LIMITS = {'x': (-5.0, 5.0), 'y': (-5.0, 5.0)}
NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
NUISANCE = ('bias_LYA', 'beta_LYA')
# log-likelihoods against vega_tpu's (f64 both sides, sums ordered
# differently), and against the port's own log_lik_batch
JAX_RTOL = 1e-9
SELF_RTOL = 1e-13


def gaussian_loglik(params):
    """tests/test_samplers.py's likelihood: N(0, 1) per dimension."""
    x = np.asarray(params['x'])
    y = np.asarray(params['y'])
    return -0.5 * (x ** 2 + y ** 2) - np.log(2 * np.pi)


def section(path, name='gauss', **options):
    path.mkdir(parents=True, exist_ok=True)
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['sampler'] = {'path': str(path), 'name': name,
                         **{k: str(v) for k, v in options.items()}}
    return config['sampler']


def assert_same_run(got, want, got_dir, want_dir, name='gauss'):
    """Results and written files equal bit for bit."""
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for suffix in ('.txt', '.paramnames', '.stats'):
        assert ((got_dir / (name + suffix)).read_text()
                == (want_dir / (name + suffix)).read_text()), suffix


# ----------------------------------------------------------------------
# (a) host loops, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize('proposal', ['slice', 'rwm'])
def test_nested_host_loop_equals_jax_bit_for_bit(tmp_path, proposal):
    """Same seed, same numpy likelihood: samples, weights, log-likelihoods,
    logZ, its error and the written chain, .paramnames and .stats equal
    vega_tpu's exactly."""
    options = dict(num_live=100, num_repeats=6, precision=0.05,
                   resume=False, seed=3, proposal=proposal)
    want = JaxNested(section(tmp_path / 'jax', **options), LIMITS,
                     gaussian_loglik).run()
    got = NestedSampler(section(tmp_path / 'port', **options), LIMITS,
                        gaussian_loglik).run()
    assert_same_run(got, want, tmp_path / 'port', tmp_path / 'jax')
    assert abs(got['logz'] + np.log(100.0)) < 0.5


def test_smc_equals_jax_bit_for_bit(tmp_path):
    options = dict(n_effective=300, n_mcmc=4, resume=False, seed=5)
    want = JaxSMC(section(tmp_path / 'jax', **options), LIMITS,
                  gaussian_loglik).run()
    got = SMCSampler(section(tmp_path / 'port', **options), LIMITS,
                     gaussian_loglik).run()
    assert_same_run(got, want, tmp_path / 'port', tmp_path / 'jax')
    assert abs(got['logz'] + np.log(100.0)) < 0.5


@pytest.mark.parametrize('first', ['jax', 'port'])
def test_nested_resumes_the_other_packages_checkpoint(tmp_path, first):
    """Five iterations by one package, checkpointed every iteration; the
    run finished from that npz by each package: equal bit for bit."""
    classes = {'jax': JaxNested, 'port': NestedSampler}
    options = dict(num_live=100, num_repeats=6, precision=0.05, seed=2)
    classes[first](section(tmp_path / 'a', max_iters=5, checkpoint_every=1,
                           **options), LIMITS, gaussian_loglik).run()
    assert (tmp_path / 'a' / 'gauss.resume.npz').exists()
    shutil.copytree(tmp_path / 'a', tmp_path / 'b')
    want = JaxNested(section(tmp_path / 'a', **options), LIMITS,
                     gaussian_loglik).run()
    got = NestedSampler(section(tmp_path / 'b', **options), LIMITS,
                        gaussian_loglik).run()
    assert_same_run(got, want, tmp_path / 'b', tmp_path / 'a')
    assert len(got['loglikes']) > 5 * 25 + 100      # it went on


def test_smc_resumes_the_jax_checkpoint(tmp_path):
    options = dict(n_effective=200, n_mcmc=3, seed=1, save_every=1)
    JaxSMC(section(tmp_path / 'a', max_stages=2, **options), LIMITS,
           gaussian_loglik).run()
    shutil.copytree(tmp_path / 'a', tmp_path / 'b')
    want = JaxSMC(section(tmp_path / 'a', **options), LIMITS,
                  gaussian_loglik).run()
    got = SMCSampler(section(tmp_path / 'b', **options), LIMITS,
                     gaussian_loglik).run()
    assert_same_run(got, want, tmp_path / 'b', tmp_path / 'a')


def test_sampler_base_checks_limits_and_path(tmp_path):
    with pytest.raises(ValueError, match='well-defined prior limits'):
        NestedSampler(section(tmp_path), {'x': (None, 1.0)}, gaussian_loglik)
    config = section(tmp_path)
    config['path'] = str(tmp_path / 'missing')
    with pytest.raises(AssertionError, match='existing folder'):
        SMCSampler(config, LIMITS, gaussian_loglik)


# ----------------------------------------------------------------------
# (b) the traceable log-likelihood
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def cross(tmp_path_factory):
    """vega_tpu and port interfaces on one tiny auto+cross dataset with
    8 x 8 grid nodes, the port serving vega_tpu's payload; and a dense
    port (VEGA_TPU_FACTORED=0)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        tmp = tmp_path_factory.mktemp('cross')
        main = jax_make_dataset(
            tmp, cross=True, size='tiny', noise=1.0, seed=2,
            extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n'
                          'ds-matmul = False')
        jax_vega = JaxInterface(main)
        jgc.save_payload(tmp / 'payload.npz', jax_vega.get_collapsed(NAMES))
        port = VegaInterface(main, device='cpu')
        port.use_grid_payload(NAMES, gc.load_payload(tmp / 'payload.npz'))
        with pytest.MonkeyPatch.context() as dense_mp:
            dense_mp.setenv('VEGA_TPU_FACTORED', '0')
            dense = VegaInterface(main, device='cpu')
        yield {'main': main, 'jax': jax_vega, 'port': port, 'dense': dense}


def theta_rows(names, n=7, seed=0):
    """n points inside the node domain, columns ordered as `names`."""
    rng = np.random.default_rng(seed)
    columns = {'ap': rng.uniform(0.8, 1.2, n), 'at': rng.uniform(0.8, 1.2, n),
               'bias_LYA': -0.117 * (1 + 0.05 * rng.normal(size=n)),
               'beta_LYA': 1.67 * (1 + 0.05 * rng.normal(size=n))}
    return np.stack([columns[name] for name in names], axis=1)


@pytest.mark.parametrize('regime', ['grid_payload', 'nuisance', 'dense'])
def test_traceable_log_lik_matches_jax(cross, monkeypatch, regime):
    """traceable_log_lik(names) on a (7, ndim) tensor against vega_tpu's
    (JAX_RTOL) and the port's log_lik_batch (SELF_RTOL)."""
    names = NUISANCE if regime == 'nuisance' else NAMES
    port = cross['dense' if regime == 'dense' else 'port']
    jax_vega = cross['jax']
    if regime == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')   # vega_tpu: at trace
        jax_vega = JaxInterface(cross['main'])
    theta = theta_rows(names)
    log_lik = BatchedLikelihood(port).traceable_log_lik(names)
    got = log_lik(torch.as_tensor(theta))
    assert isinstance(got, torch.Tensor) and got.shape == (7,)
    batch_fn, statics, collapsed = JaxBatched(jax_vega).traceable_log_lik(
        names)
    want = np.asarray(batch_fn(jnp.asarray(theta), statics, collapsed))
    assert np.max(np.abs(got.numpy() - want) / np.abs(want)) <= JAX_RTOL
    own = port.log_lik_batch(
        {name: theta[:, i] for i, name in enumerate(names)}).numpy()
    assert np.max(np.abs(got.numpy() - own) / np.abs(own)) <= SELF_RTOL
    assert not log_lik.stale()


def test_traceable_log_lik_goes_stale_with_the_data(cross):
    """The function reads the data vectors current when it was built: a
    Monte-Carlo mock after that makes it stale."""
    port = VegaInterface(cross['main'], device='cpu')
    log_lik = BatchedLikelihood(port).traceable_log_lik(NUISANCE)
    assert not log_lik.stale()
    for data in port.data.values():
        data.masked_mc_mock = data.masked_data_vec * 1.01
    port.monte_carlo = True
    assert log_lik.stale()


# ----------------------------------------------------------------------
# (c) the device evolve, against a numpy transcription of vega_tpu's loop
# ----------------------------------------------------------------------
def numpy_slice_evolve(log_lik_u, u0, l_min, width, chol, normals, offsets,
                       shrinks):
    """vega_tpu/samplers/nested.py:212-254 (`repeat_body`, `shrink_body`)
    in numpy, with the random numbers fed in where it splits keys."""
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
            t = np.where(done, 0.0, t)
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


def test_slice_evolve_equals_the_numpy_transcription():
    """Hand-fed random numbers, the toy Gaussian on [-5, 5]^2: u and logl
    within 1e-13 (the direction's two-term products may round apart),
    steps and moves equal; some chains accept early and some never."""
    rng = np.random.default_rng(11)
    n, ndim, repeats, shrink = 25, 2, 4, 4
    u0 = rng.uniform(0.3, 0.7, (n, ndim))
    chol = np.linalg.cholesky(np.cov(rng.uniform(size=(100, ndim)),
                                     rowvar=False))
    randoms = (rng.standard_normal((repeats, n, ndim)),
               rng.uniform(size=(repeats, n)),
               rng.uniform(size=(repeats, shrink, n)))
    l_min, width = -2.0, 2.0

    def log_lik_np(u):
        x = -5.0 + 10.0 * u
        return -0.5 * np.sum(x ** 2, axis=1) - np.log(2 * np.pi)

    def log_lik_torch(u):
        x = -5.0 + 10.0 * u
        return -0.5 * torch.sum(x ** 2, dim=1) - np.log(2 * np.pi)

    want = numpy_slice_evolve(log_lik_np, u0, l_min, width, chol, *randoms)
    got = tnested.slice_evolve(
        log_lik_torch, torch.as_tensor(u0), torch.tensor(l_min).double(),
        torch.tensor(width).double(), torch.as_tensor(chol),
        *(torch.as_tensor(r) for r in randoms))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-13)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-13)
    assert (int(got[2]), int(got[3])) == want[2:]
    assert 0 < want[3] < repeats * n          # both kinds of chain
    assert want[2] > want[3]                  # and rejected proposals


@pytest.fixture(scope='module')
def auto(tmp_path_factory):
    """vega_tpu and port interfaces on tests/test_samplers.py's tiny auto
    dataset (noise = 1)."""
    tmp = tmp_path_factory.mktemp('auto')
    main = jax_make_dataset(tmp, cross=False, size='tiny', noise=1.0)
    return {'main': main, 'tmp': tmp, 'jax': JaxInterface(main),
            'port': VegaInterface(main, device='cpu')}


AUTO_LIMITS = {'bias_LYA': (-0.3, -0.01), 'beta_LYA': (0.5, 3.0)}


def test_device_evolve_makes_no_host_sync(auto, monkeypatch):
    """DeviceEvolve.run (the slice evolution around traceable_log_lik)
    with every host read of a tensor patched to raise; its results equal
    the numpy transcription driven by the port's log_lik_batch (1e-9:
    log-likelihoods of the same function, evaluated in other batches)."""
    port = auto['port']
    names = list(AUTO_LIMITS)
    evolve = tnested.DeviceEvolve(BatchedLikelihood(port), names,
                                  AUTO_LIMITS, 10, 3, 4, seed=5)
    assert evolve.graph is None               # a CPU device runs eagerly
    rng = np.random.default_rng(4)
    start = rng.uniform(0.35, 0.45, (10, 2))
    chol = 0.02 * np.eye(2)
    lo = np.array([AUTO_LIMITS[n][0] for n in names])
    hi = np.array([AUTO_LIMITS[n][1] for n in names])

    def log_lik_np(u):
        theta = lo + u * (hi - lo)
        return port.log_lik_batch(
            {name: theta[:, i] for i, name in enumerate(names)}).numpy()

    l_min = float(np.median(log_lik_np(start)))
    evolve.load(start, l_min, 2.0, chol)
    evolve.draw(9)
    randoms = [r.numpy().copy() for r in evolve.randoms]

    def refuse(*args, **kwargs):
        raise AssertionError('host sync inside the device evolve')

    with monkeypatch.context() as mp:
        for method in ('item', 'cpu', 'tolist', 'numpy', '__bool__',
                       '__float__', '__int__', '__index__'):
            mp.setattr(torch.Tensor, method, refuse)
        out = evolve.run()
    out = out.numpy()
    want = numpy_slice_evolve(log_lik_np, start, l_min, 2.0, chol, *randoms)
    np.testing.assert_allclose(out[:20].reshape(10, 2), want[0], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(out[20:30], want[1], rtol=1e-9)
    assert (int(out[30]), int(out[31])) == want[2:]
    # the same through the call a sampler makes, seeded by the iteration
    u, logl, steps, moves = evolve(start, l_min, 2.0, chol, 9)
    np.testing.assert_array_equal(u, out[:20].reshape(10, 2))
    np.testing.assert_array_equal(logl, out[20:30])
    assert (steps, moves) == want[2:]
    assert not evolve.stale(10) and evolve.stale(11)


# ----------------------------------------------------------------------
# (d) device loop vs host loop vs vega_tpu's host loop
# ----------------------------------------------------------------------
def moments(result):
    mean = np.average(result['samples'], axis=0, weights=result['weights'])
    std = np.sqrt(np.average((result['samples'] - mean) ** 2, axis=0,
                             weights=result['weights']))
    return mean, std


def test_nested_device_loop_matches_the_host_loops(auto):
    """tests/test_samplers.py:96-136's run (num_live 100, num_repeats 6,
    precision 0.05, seed 7) by the port's device loop, the port's host
    loop and vega_tpu's host loop: logZ within 3 max(errors, 0.1),
    weighted means within 1 posterior sigma (vega_tpu's own test allows
    3), sigmas within 60%. The port's host loop sees log-likelihoods that
    differ from vega_tpu's in the last digits, so it is held to it the
    same way, not bit for bit."""
    runs = {}
    for label, cls, batched, device_loop in (
            ('device', NestedSampler, BatchedLikelihood(auto['port']), True),
            ('host', NestedSampler, BatchedLikelihood(auto['port']), False),
            ('jax', JaxNested, JaxBatched(auto['jax']), False)):
        out = auto['tmp'] / f'out_{label}'
        sampler = cls(section(out, name=f'ns_{label}', num_live=100,
                              num_repeats=6, precision=0.05, resume=False,
                              seed=7, device_loop=device_loop),
                      AUTO_LIMITS, batched)
        assert sampler._batched is batched
        assert sampler.device_loop is device_loop
        runs[label] = sampler.run()
        assert np.isfinite(runs[label]['logz'])
        chain = np.loadtxt(out / f'ns_{label}.txt')
        assert chain.shape[1] == 4 and np.isfinite(chain).all()
        stats = (out / f'ns_{label}.stats').read_text()
        if label == 'device':
            # n (1 + num_repeats max_shrink) rows per iteration and the
            # first live points
            iterations = int(stats.split('num_iterations = ')[1].split()[0])
            assert f'num_like_evals = {100 + iterations * 25 * 73}' in stats
    for a, b in (('device', 'host'), ('device', 'jax'), ('host', 'jax')):
        ra, rb = runs[a], runs[b]
        assert abs(ra['logz'] - rb['logz']) <= 3.0 * max(
            ra['logz_err'], rb['logz_err'], 0.1), (a, b)
        (mean_a, std_a), (mean_b, std_b) = moments(ra), moments(rb)
        assert np.all(np.abs(mean_a - mean_b)
                      <= np.maximum(std_a, std_b)), (a, b)
        assert np.all(np.abs(std_a / std_b - 1) <= 0.6), (a, b)


def test_device_loop_env_switch(auto, monkeypatch):
    monkeypatch.setenv('VEGA_TPU_NS_DEVICE_LOOP', '0')
    sampler = NestedSampler(section(auto['tmp'] / 'env'), AUTO_LIMITS,
                            BatchedLikelihood(auto['port']))
    assert sampler.device_loop is False
    sampler = NestedSampler(section(auto['tmp'] / 'env', device_loop=True),
                            AUTO_LIMITS, BatchedLikelihood(auto['port']))
    assert sampler.device_loop is True


# ----------------------------------------------------------------------
# (g) routing, flags and the script
# ----------------------------------------------------------------------
def test_polychord_and_pocomc_route_to_the_native_samplers(tmp_path, capsys):
    nested = Polychord(section(tmp_path, num_live=50), LIMITS,
                       gaussian_loglik, {'lyaxlya': 2})
    assert type(nested) is NestedSampler and nested.num_live == 50
    assert 'using the native batched nested sampler' in capsys.readouterr().out
    # the native chain has no derived columns, and says so in .paramnames
    assert len((tmp_path / 'gauss.paramnames').read_text().splitlines()) == 2
    smc = PocoMC(section(tmp_path, n_effective=64), LIMITS, gaussian_loglik)
    assert type(smc) is SMCSampler and smc.n_particles == 64
    assert 'using the native batched SMC' in capsys.readouterr().out


def test_sampler_flags(auto):
    port = auto['port']
    assert port.run_sampler is False and port.sampler is None
    # no marginalization: every correlation carries 0 derived columns,
    # as vega_tpu's dict says
    assert port.corr_num_marg_modes == auto['jax'].corr_num_marg_modes \
        == {'lyaxlya': 0}
    with pytest.raises(ValueError, match='Sampler not recognized'):
        VegaInterface(with_control(
            auto['main'], 'run_sampler = True\nsampler = Emcee\n',
            auto['tmp'] / 'main_emcee.ini'), device='cpu')
    with pytest.raises(RuntimeError, match='no sampler config found'):
        VegaInterface(with_control(
            auto['main'], 'run_sampler = True\nsampler = HMC\n',
            auto['tmp'] / 'main_hmc.ini'), device='cpu')
    named = VegaInterface(with_control(
        auto['main'], 'run_sampler = True\nsampler = PocoMC\n',
        auto['tmp'] / 'main_named.ini', '\n[PocoMC]\npath = .\nname = x\n'),
        device='cpu')
    assert named.run_sampler is True and named.sampler == 'PocoMC'
    with pytest.raises(ValueError, match='Sampler not requested'):
        run_vega_sampler.main([str(auto['main']), '--device', 'cpu'])


@pytest.mark.parametrize('name,section_text,columns', [
    ('NestedJax', 'num_live = 50\nnum_repeats = 5\nprecision = 0.1\n'
                  'resume = False\nmax_iters = 150\n', None),
    ('Polychord', 'num_live = 40\nnum_repeats = 4\nprecision = 0.2\n'
                  'resume = False\nmax_iters = 100\n', None),
    ('PocoMC', 'n_effective = 64\nn_mcmc = 2\nresume = False\n', 64),
])
def test_run_vega_sampler(auto, name, section_text, columns):
    """The assertions of vega_tpu's own nested-sampler script test, on
    the port's script, for each sampler name that needs no gradient."""
    out_dir = auto['tmp'] / f'output_{name}'
    out_dir.mkdir()
    main = with_control(
        auto['main'], f'run_sampler = True\nsampler = {name}\n',
        auto['tmp'] / f'main_{name}.ini',
        f'\n[{name}]\npath = {out_dir}\nname = synth\n' + section_text)
    assert run_vega_sampler.main([str(main), '--device', 'cpu']) == 0
    assert (out_dir / 'synth.paramnames').exists()
    chain = np.loadtxt(out_dir / 'synth.txt')
    assert chain.shape[1] == 4  # weight, -2lnL, 2 params
    assert np.isfinite(chain).all()
    if columns is not None:
        assert chain.shape[0] == columns
    lo, hi = np.array(list(VegaInterface(main, device='cpu')
                           .sample_params['limits'].values())).T
    assert np.all((chain[:, 2:] >= lo) & (chain[:, 2:] <= hi))


def test_run_vega_sampler_on_a_monte_carlo_mock(auto):
    """run_montecarlo = True: the script draws the mock first
    (initialize_monte_carlo, after a fit) and samples the [monte carlo]
    parameters against it; without that section it raises."""
    out_dir = auto['tmp'] / 'output_mc'
    out_dir.mkdir()
    control = 'run_sampler = True\nsampler = NestedJax\nrun_montecarlo = True\n'
    sampler = (f'\n[NestedJax]\npath = {out_dir}\nname = mc\nnum_live = 40\n'
               'num_repeats = 4\nprecision = 0.2\nresume = False\n'
               'max_iters = 60\n')
    with pytest.raises(ValueError, match=r'no "\[monte carlo\]" section'):
        run_vega_sampler.main([str(with_control(
            auto['main'], control, auto['tmp'] / 'main_mc_none.ini',
            sampler)), '--device', 'cpu'])
    main = with_control(
        auto['main'], control + 'mc_seed = 4\n',
        auto['tmp'] / 'main_mc.ini',
        sampler + '\n[monte carlo]\nbias_LYA = -0.3 -0.01 -0.12 0.01\n'
        'beta_LYA = 0.5 3.0 1.6 0.1\n'
        '\n[mc parameters]\nbias_LYA = -0.117\nbeta_LYA = 1.67\n')
    vega, ns, result = run_vega_sampler.run([str(main), '--device', 'cpu'])
    assert vega.monte_carlo is True
    assert ns.names == ['bias_LYA', 'beta_LYA']
    chain = np.loadtxt(out_dir / 'mc.txt')
    assert chain.shape[1] == 4 and np.isfinite(chain).all()
    # the chain's -2 ln L is the likelihood of the mock, not of the data
    want = -2 * vega.log_lik_batch({'bias_LYA': chain[-5:, 2],
                                    'beta_LYA': chain[-5:, 3]}).numpy()
    np.testing.assert_allclose(chain[-5:, 1], want, rtol=1e-9)
