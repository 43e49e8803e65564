"""Several devices in one process in the PyTorch port
(vega_tpu_torch.parallel: make_device_mesh, BatchedLikelihood over a
mesh, the sharded batched Newton of batched_chi2_scan and
MonteCarloEngine, the interface's replicas on other devices,
ShardedGlobalChi2) and the device guard of the kernel launches, against
the JAX package (vega_tpu) on its eight virtual CPU devices
(tests/conftest.py), on the CPU.

The port's counterpart of vega_tpu's eight CPU devices is a mesh of the
CPU listed eight times: the split, the padding and the gather run as on
eight cards. One tiny synthetic auto+cross dataset with noise (seed 3),
(ap, at, bias_LYA, beta_LYA) sampled, 8 x 8 grid nodes and the exact f64
payload contractions, made by vega_tpu; the port serves vega_tpu's
payload. Each tolerance stands beside its use.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import contextlib
import copy

import numpy as np
import pytest
import torch

import vega_tpu.gridcollapse as jgc
from vega_tpu.parallel import ShardedGlobalChi2 as JaxShardedGlobalChi2
from vega_tpu.parallel import batch as jbatch
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.ops import graphs, spline_combine
from vega_tpu_torch.parallel import (BatchedLikelihood, DeviceMesh,
                                     MonteCarloEngine, ShardedGlobalChi2,
                                     batched_chi2_scan, make_device_mesh)
from vega_tpu_torch.parallel import batch as tbatch
from vega_tpu_torch.vega_interface import VegaInterface

# fits (scan points, mocks) against vega_tpu's from the same start are
# held as tests/test_torch_analysis.py holds them: values within
# FIT_SIGMA of their errors, errors within FIT_ERR_RTOL, chi^2 within
# FIT_CHI2_ABS
from test_torch_analysis import (FIT_CHI2_ABS, FIT_ERR_RTOL,  # noqa: E402
                                 FIT_SIGMA, assert_rows_match, numpy_mocks,
                                 nuisance_sample)

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
NUISANCE = ('bias_LYA', 'beta_LYA')
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
MC_PARAMS = {'bias_LYA': -0.117, 'beta_LYA': 1.67}
CONTROL = ('grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
           '\n[monte carlo]\n'
           'bias_LYA = -1.0 0.0 -0.12 0.01\nbeta_LYA = 0.0 3.0 1.6 0.1\n\n'
           '[mc parameters]\n'
           + ''.join(f'{k} = {v}\n' for k, v in MC_PARAMS.items()))
BATCHES = (1, 7, 64, 65)
# the sharded chi^2 against vega_tpu's sharded chi^2 and against the
# port's unsharded chi2_batch, relative to |chi^2| (f64 both sides)
SHARD_RTOL = 1e-12
COV_RTOL = 1e-12         # tests/test_sharded_global_cov.py's bound


def cpu_mesh(n=8):
    return make_device_mesh(devices=['cpu'] * n)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        mp.delenv('VEGA_TPU_FIT_CHUNK_PER_DEVICE', raising=False)
        tmp = tmp_path_factory.mktemp('devices')
        main = jax_make_dataset(tmp, cross=True, size='tiny', sample=SAMPLE,
                                seed=3, noise=1.0, extra_control=CONTROL)
        jax_vega = JaxInterface(main)
        jgc.save_payload(tmp / 'payload.npz', jax_vega.get_collapsed(NAMES))
        port = VegaInterface(main, device='cpu')
        port.use_grid_payload(NAMES, gc.load_payload(tmp / 'payload.npz'))
        with pytest.MonkeyPatch.context() as dense_mp:
            dense_mp.setenv('VEGA_TPU_FACTORED', '0')
            dense = VegaInterface(main, device='cpu')
        yield {'main': main, 'jax': jax_vega, 'port': port, 'dense': dense}


def draw(n_rows, seed):
    rng = np.random.default_rng(seed)
    return {'ap': rng.uniform(0.9, 1.1, n_rows),
            'at': rng.uniform(0.9, 1.1, n_rows),
            'bias_LYA': rng.uniform(-0.13, -0.11, n_rows),
            'beta_LYA': rng.uniform(1.5, 1.8, n_rows)}


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@contextlib.contextmanager
def jax_regime(regime):
    """vega_tpu reads VEGA_TPU_FACTORED when it traces a call."""
    with pytest.MonkeyPatch.context() as mp:
        if regime == 'dense':
            mp.setenv('VEGA_TPU_FACTORED', '0')
        yield


# ----------------------------------------------------------------------
# Meshes
# ----------------------------------------------------------------------
@pytest.mark.parametrize('n', [None, 1, 2, 5, 8, 12])
def test_make_device_mesh_slices_as_jax(n):
    """make_device_mesh(n) cuts the device list as vega_tpu cuts
    jax.devices() (its first n), over eight entries; on one card a mesh
    of two is a mesh of that card."""
    want = jbatch.make_device_mesh(n)
    got = make_device_mesh(n, devices=['cpu'] * 8)
    assert got.size == want.devices.size
    assert got.axis_names == tuple(want.axis_names) == ('batch',)
    assert got.devices == (torch.device('cpu'),) * got.size
    assert make_device_mesh(n, devices=['cuda:0']).size == 1


def test_make_device_mesh_needs_a_card_or_a_list(monkeypatch):
    """With no CUDA device the default mesh raises: the CPU is asked for
    with an explicit device list, never taken instead."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_device_mesh()
    with pytest.raises(ValueError):
        DeviceMesh([])


# ----------------------------------------------------------------------
# BatchedLikelihood over a mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize('regime', ['grid', 'dense'])
def test_sharded_chi2_matches_jax(setup, regime):
    """BatchedLikelihood(mesh=the CPU listed 8 times).chi2 at B = 1, 7,
    64, 65 against vega_tpu's BatchedLikelihood over its 8-device mesh and
    against the port's unsharded chi2_batch (SHARD_RTOL); with a chunk of
    4 rows per device (B = 65 padded to 96) as well."""
    port = setup['port' if regime == 'grid' else 'dense']
    want_bl = jbatch.BatchedLikelihood(setup['jax'],
                                       mesh=jbatch.make_device_mesh(8))
    for n_rows in BATCHES:
        batch = draw(n_rows, n_rows)
        with jax_regime(regime):
            want = np.asarray(want_bl.chi2(batch))
        for bl in (BatchedLikelihood(port, mesh=cpu_mesh()),
                   BatchedLikelihood(port, mesh=cpu_mesh(),
                                     chunk_per_device=4)):
            got = bl.chi2(batch)
            assert got.shape == (n_rows,) and got.dtype == torch.float64
            assert max_rel(got.numpy(), want) <= SHARD_RTOL
            assert max_rel(got.numpy(),
                           port.chi2_batch(batch).numpy()) <= SHARD_RTOL


def test_sharded_log_lik_matches_jax(setup):
    """log_lik over the mesh: vega_tpu's (SHARD_RTOL)."""
    batch = draw(13, 0)
    got = BatchedLikelihood(setup['port'], mesh=cpu_mesh()).log_lik(batch)
    want = jbatch.BatchedLikelihood(
        setup['jax'], mesh=jbatch.make_device_mesh(8)).log_lik(batch)
    assert max_rel(got.numpy(), want) <= SHARD_RTOL


def test_keywords_of_both_packages(setup):
    """chunk_rows (the port's) and chunk_per_device (vega_tpu's) name
    one bound; two different values refuse. The default mesh of an
    interface on the CPU is that CPU alone (the unsharded call)."""
    port = setup['port']
    assert BatchedLikelihood(port, chunk_per_device=16).chunk_rows == 16
    assert BatchedLikelihood(port, chunk_rows=16,
                             chunk_per_device=16).chunk_per_device == 16
    with pytest.raises(ValueError):
        BatchedLikelihood(port, chunk_rows=8, chunk_per_device=16)
    bl = BatchedLikelihood(port)
    assert bl.mesh.devices == (torch.device('cpu'),) and bl.n_devices == 1


# ----------------------------------------------------------------------
# The sharded batched Newton
# ----------------------------------------------------------------------
def test_sharded_scan_matches_jax(setup, monkeypatch):
    """batched_chi2_scan of 2 x 3 (ap, at) points over the 8-entry mesh
    in chunks of 1 row per device (two chunks, the second padded),
    against vega_tpu's over its 8 devices at the same chunk and against
    the port's unsharded scan (test_torch_analysis.py's gates)."""
    monkeypatch.setenv('VEGA_TPU_FIT_CHUNK_PER_DEVICE', '1')
    grids = {'ap': np.array([0.98, 1.02]), 'at': np.array([0.97, 1.0, 1.03])}
    stats = {}
    got = batched_chi2_scan(setup['port'], grids, mesh=cpu_mesh(),
                            max_iterations=30, stats=stats)
    want = jbatch.batched_chi2_scan(setup['jax'], grids,
                                    mesh=jbatch.make_device_mesh(8),
                                    max_iterations=30)
    assert_rows_match(got, want)
    # one loop per (chunk, entry): 6 points over 8 entries, one row each
    assert len(stats['iterations']) == 8 and stats['valid_rows'] == 6
    assert_rows_match(got, batched_chi2_scan(setup['port'], grids,
                                             max_iterations=30))


@pytest.mark.parametrize('sampled', ['collapse', 'dense'])
def test_sharded_fit_mocks_match_jax(setup, sampled, monkeypatch):
    """MonteCarloEngine(mesh=8 entries).fit_mocks on 11 identical numpy
    mocks, 2 rows per device per chunk, against vega_tpu's engine over its
    8 devices (test_torch_analysis.py's gates)."""
    monkeypatch.setenv('VEGA_TPU_FIT_CHUNK_PER_DEVICE', '2')
    port, jax_vega = setup['port'], setup['jax']
    fiducial = jax_vega.compute_model(MC_PARAMS, run_init=False)
    mocks = numpy_mocks(port, fiducial, 11, seed=5)
    sample = (nuisance_sample(port) if sampled == 'collapse'
              else port.sample_params)
    got = MonteCarloEngine(port, mesh=cpu_mesh()).fit_mocks(
        mocks, sample, max_iterations=50)
    want = jbatch.MonteCarloEngine(
        jax_vega, mesh=jbatch.make_device_mesh(8)).fit_mocks(
            mocks, copy.deepcopy(sample), max_iterations=50)
    assert list(got['names']) == list(want['names'])
    errors = np.asarray(want['errors'])
    assert np.max(np.abs(got['values'] - want['values']) / errors) \
        <= FIT_SIGMA
    assert np.max(np.abs(got['errors'] / errors - 1)) <= FIT_ERR_RTOL
    assert np.max(np.abs(got['chisq'] - want['chisq'])) <= FIT_CHI2_ABS
    np.testing.assert_array_equal(got['valid'], want['valid'])
    assert got['valid'].all()


def test_newton_entries_equal_one_device():
    """The sharded Newton on a quadratic: 13 rows over 3 entries in
    chunks of 2 rows per entry give each row's fit of the unsharded run,
    bit for bit (rows are independent), and stats count every (chunk,
    entry) loop and the real rows only."""
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.uniform(0.5, 2.0, size=(13, 2)))
    c = torch.as_tensor(rng.normal(size=(13, 2)))

    def derivatives(x, chunk):
        d = x - chunk['c']
        return ((chunk['a'] * d ** 2).sum(-1), 2 * chunk['a'] * d,
                torch.diag_embed(2 * chunk['a']))

    x0 = torch.zeros(2, dtype=torch.float64)
    lo, hi = torch.full_like(x0, -np.inf), torch.full_like(x0, np.inf)
    stats = {}
    sharded = tbatch._newton_minimize_batched(
        derivatives, x0, lo, hi, {'a': a, 'c': c}, 20, chunk_per_device=2,
        stats=stats, mesh=cpu_mesh(3))
    whole = tbatch._newton_minimize_batched(
        derivatives, x0, lo, hi, {'a': a, 'c': c}, 20, chunk_per_device=13)
    for got, want in zip(sharded, whole):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert len(stats['iterations']) == 3 * 3 and stats['valid_rows'] == 13


# ----------------------------------------------------------------------
# Replicas on other devices
# ----------------------------------------------------------------------
def test_replicas_copy_the_payload_and_follow_the_data(setup, monkeypatch):
    """Every entry taken as another device (so each shard runs on a
    replica of the interface): the replica is built once, finds the grid
    payload in the interface's cache (a second sweep raises here), gives
    the unsharded chi^2 on the payload and on the dense path
    (SHARD_RTOL), follows a Monte-Carlo data vector set on the interface,
    and is built again when the interface's models are."""
    monkeypatch.setattr(tbatch, '_same_device', lambda a, b: False)
    port, dense = setup['port'], setup['dense']
    built = []
    build = tbatch._build_replica
    monkeypatch.setattr(tbatch, '_build_replica',
                        lambda vega, device: built.append(device)
                        or build(vega, device))

    def no_sweep(*args, **kwargs):
        raise AssertionError('a replica swept the grid payload again')
    monkeypatch.setattr(gc, 'build_grid_payload', no_sweep)
    batch = draw(21, 1)
    for vega in (port, dense):
        bl = BatchedLikelihood(vega, mesh=cpu_mesh(4))
        assert max_rel(bl.chi2(batch).numpy(),
                       vega.chi2_batch(batch).numpy()) <= SHARD_RTOL
    assert len(built) == 2          # one replica per interface
    replica = tbatch.replica_on(port, 'cpu')
    assert replica is not port and replica.models is not port.models
    assert replica._grid_cache is port._grid_cache

    vega = VegaInterface(setup['main'], device='cpu')
    fiducial = vega.compute_model(MC_PARAMS, run_init=False)
    mocks = numpy_mocks(vega, fiducial, 1, seed=9)
    nuis = {k: batch[k] for k in NUISANCE}
    bl = BatchedLikelihood(vega, mesh=cpu_mesh(3))
    bl.chi2(nuis)
    for name, data in vega.data.items():
        data.mc_mock = np.zeros(data.data_vec.size)
        data.mc_mock[data.data_mask] = mocks[name][0]
        data.masked_mc_mock = mocks[name][0]
    vega.monte_carlo = True
    assert max_rel(bl.chi2(nuis).numpy(),
                   vega.chi2_batch(nuis).numpy()) <= SHARD_RTOL
    n_built = len(built)
    vega.compute_model(run_init=True)       # new models: a new replica
    bl.chi2(nuis)
    assert len(built) == n_built + 1


# ----------------------------------------------------------------------
# ShardedGlobalChi2 (tests/test_sharded_global_cov.py's cases)
# ----------------------------------------------------------------------
def spd(n, rng):
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def test_global_chi2_matches_numpy():
    rng = np.random.default_rng(0)
    n = 101     # deliberately not a multiple of the mesh size
    invcov = spd(n, rng)
    diff = rng.normal(size=n)
    got = ShardedGlobalChi2(invcov, mesh=cpu_mesh()).chi2(diff)
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(float(got), diff @ invcov @ diff,
                               rtol=COV_RTOL)
    want = JaxShardedGlobalChi2(invcov, mesh=jbatch.make_device_mesh(8))
    np.testing.assert_allclose(float(got), float(want.chi2(diff)),
                               rtol=COV_RTOL)


def test_global_chi2_batched():
    rng = np.random.default_rng(1)
    n, b = 64, 5
    invcov = spd(n, rng)
    diffs = rng.normal(size=(b, n))
    got = ShardedGlobalChi2(invcov, mesh=cpu_mesh()).chi2_batch(diffs)
    np.testing.assert_allclose(
        got.numpy(), np.einsum('bi,ij,bj->b', diffs, invcov, diffs),
        rtol=COV_RTOL)


def test_global_chi2_rows_actually_sharded():
    sharded = ShardedGlobalChi2(spd(96, np.random.default_rng(2)),
                                mesh=cpu_mesh())
    assert {tuple(block.shape) for _, block in sharded._blocks} == {(12, 96)}
    assert [entry for entry, _ in sharded._blocks] == list(range(8))


# ----------------------------------------------------------------------
# The device guard of the kernel launches
# ----------------------------------------------------------------------
class DeviceRecorder:
    """Stand-in for torch.cuda's current device: `device(d)` makes d
    current inside its block; `current_stream(d)` hands out a stream of
    d, refusing to while another device is current (the CUDA runtime
    would take the stream of another device)."""

    def __init__(self):
        self.current = torch.device('cuda', 0)
        self.entered = []

    @contextlib.contextmanager
    def device(self, device):
        before, self.current = self.current, torch.device(device)
        self.entered.append(self.current)
        try:
            yield
        finally:
            self.current = before

    def current_stream(self, device):
        assert torch.device(device) == self.current, (device, self.current)
        return type('Stream', (), {'cuda_stream': 1000 + device.index})()


def test_launches_run_under_their_device(monkeypatch):
    """spline_combine._launch with a stubbed library: each entry point
    runs with its tensors' device current and that device's stream,
    cuda:0 current before and after; a refused launch still raises."""
    recorder = DeviceRecorder()
    monkeypatch.setattr(torch.cuda, 'device', recorder.device)
    monkeypatch.setattr(torch.cuda, 'current_stream', recorder.current_stream)
    seen = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                seen.append((name, recorder.current, args[-1]))
                return 0 if args[0] == 'ok' else 2
            return entry

        @staticmethod
        def vega_cuda_error_string(err):
            return b'stubbed refusal'

    from vega_tpu_torch.ops import _build
    monkeypatch.setattr(_build, 'load_library',
                        lambda: type('L', (), {'lib': Lib()})())
    grid = type('Grid', (), {'dtype': torch.float64})()
    for index in (1, 0, 3):
        device = torch.device('cuda', index)
        spline_combine._launch('vega_spline_legendre_combine', grid, device,
                               'ok')
        assert seen[-1] == ('vega_spline_legendre_combine_f64', device,
                            1000 + index)
        assert recorder.current == torch.device('cuda', 0)
    with pytest.raises(RuntimeError, match='stubbed refusal'):
        spline_combine._launch('vega_spline_legendre_points', grid,
                               torch.device('cuda', 2), 'refused')
    assert seen[-1][1] == torch.device('cuda', 2)


def test_graphs_capture_and_replay_under_their_device(monkeypatch):
    """CapturedGraph makes its device current for the capture and for
    every replay."""
    recorder = DeviceRecorder()
    monkeypatch.setattr(torch.cuda, 'device', recorder.device)
    events = []

    class FakeGraph:
        def replay(self):
            events.append(('replay', recorder.current))

    @contextlib.contextmanager
    def fake_capture(graph):
        events.append(('capture', recorder.current))
        yield

    class FakeStream:
        def __init__(self, device):
            events.append(('stream', recorder.current))

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, 'Stream', FakeStream)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device: FakeStream(device))
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', FakeGraph)
    monkeypatch.setattr(torch.cuda, 'graph', fake_capture)
    device = torch.device('cuda', 2)
    graph = graphs.CapturedGraph(lambda: torch.zeros(1), device)
    graph.replay()
    assert {d for _, d in events} == {device}
    assert [kind for kind, _ in events][-2:] == ['capture', 'replay']
    assert recorder.current == torch.device('cuda', 0)
