"""The grid payload's disk cache and resumable sweeps in the PyTorch port
(vega_tpu_torch.gridcollapse.payload_fingerprint / payload_cache_dir,
the sweep's part files, VegaInterface._get_grid_collapsed), mirroring
tests/test_payload_fingerprint.py, on the CPU at size='tiny': what the
fingerprint hashes, a miss that sweeps and saves, a hit that sweeps
nothing, a corrupt entry, Monte-Carlo mode, payload files read across the
two packages, and an interrupted sweep that resumes from its parts. Each
test has a cache directory of its own; each tolerance stands beside its
use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import os

import numpy as np
import pytest
import torch

import vega_tpu.gridcollapse as jgc
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.io.fits import read_fits, write_fits
from vega_tpu_torch.testing import (DESI_METALS, DR16_METALS,
                                    desi_extra_model, dr16_extra_model,
                                    make_synthetic_dataset)
from vega_tpu_torch.vega_interface import VegaInterface

NAMES = ('ap', 'at', 'beta_LYA', 'bias_LYA')
SAMPLE = {'ap': 'True', 'at': 'True', 'bias_LYA': 'True',
          'beta_LYA': 'True'}
CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
GRID_ABS, GRID_REL = 1e-8, 1e-10    # one payload served by both packages
SPEC = gc.GridSpec(('ap', 'at'), (0.9, 0.9), (1.1, 1.1), (8, 8), (1.0, 1.0))


def batch(n=8, seed=2):
    rng = np.random.default_rng(seed)
    return {'ap': rng.uniform(0.8, 1.2, n), 'at': rng.uniform(0.8, 1.2, n),
            'bias_LYA': -0.117 * (1 + 0.05 * rng.normal(size=n)),
            'beta_LYA': 1.67 * (1 + 0.05 * rng.normal(size=n))}


@pytest.fixture(scope='module', autouse=True)
def env():
    """The exact f64 payload contractions and both dispatch switches at
    their defaults; the disk cache off unless a test points it at its own
    directory (`cache_in`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_GRID_CACHE_DIR', raising=False)
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield


def cache_in(monkeypatch, path):
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE', '1')
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE_DIR', str(path))
    return path


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """(main.ini, vega_tpu's interface with its payload built) of the
    tiny auto+cross dataset with noise, 8 x 8 nodes."""
    main = jax_make_dataset(tmp_path_factory.mktemp('cache'), cross=True,
                            size='tiny', noise=1.0, sample=SAMPLE,
                            extra_control=CONTROL)
    jax_vega = JaxInterface(main)
    jax_vega.get_collapsed(NAMES)
    return main, jax_vega


@pytest.fixture(scope='module')
def port(tiny):
    return VegaInterface(tiny[0], device='cpu')


def fingerprint(vega, extra=None):
    if vega._chi2_data is None:
        vega.set_chi2_constants()
    return gc.payload_fingerprint(vega, sorted(NAMES), SPEC, 2e-4, 1e-12,
                                  extra=extra)


def test_fingerprint_is_deterministic(tiny, port):
    """The same content gives the same fingerprint, from a second
    interface too."""
    assert fingerprint(port) == fingerprint(port)
    assert fingerprint(port) == fingerprint(
        VegaInterface(tiny[0], device='cpu'))


def test_cache_dir_and_its_switches(monkeypatch):
    monkeypatch.delenv('VEGA_TPU_GRID_CACHE_DIR', raising=False)
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE', '1')
    assert gc.payload_cache_dir() == os.path.expanduser(
        '~/.cache/vega_tpu_torch_grid')
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE_DIR', '/some/where')
    assert gc.payload_cache_dir() == '/some/where'
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE', '0')
    assert gc.payload_cache_dir() is None


@pytest.mark.parametrize('what', ['extra', 'data_vector', 'parameter'])
def test_fingerprint_follows_content(port, what):
    """`extra`, a data vector's content and a parameter value each change
    the fingerprint; putting them back restores it."""
    base = fingerprint(port)
    if what == 'extra':
        assert fingerprint(port, extra='mutated-limits') != base
        return
    data = port.data['qsoxlya']
    saved_vec, saved_param = data.masked_data_vec, port.params['sigmaNL_par']
    try:
        if what == 'data_vector':
            data.masked_data_vec = saved_vec * (1 + 1e-12)
        else:
            port.params['sigmaNL_par'] = saved_param + 1e-9
        assert fingerprint(port) != base
    finally:
        data.masked_data_vec, port.params['sigmaNL_par'] = (saved_vec,
                                                            saved_param)
    assert fingerprint(port) == base


def test_mutated_limits_change_the_cache_entry(tiny, tmp_path, monkeypatch):
    """Through _get_grid_collapsed: sampling limits changed after
    construction give another fingerprint (folded in as `extra`), the
    config's limits the first one again."""
    cache_in(monkeypatch, tmp_path)
    seen = []
    real = gc.payload_fingerprint

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    def stop(*args, **kwargs):
        raise RuntimeError('stop after the fingerprint')

    monkeypatch.setattr(gc, 'payload_fingerprint', spy)
    monkeypatch.setattr(gc, 'build_grid_payload', stop)
    vega = VegaInterface(tiny[0], device='cpu')
    limits = vega.sample_params['limits']
    for value in (None, (-0.5, 0.0), None):
        saved = limits['bias_LYA']
        if value is not None:
            limits['bias_LYA'] = value
        with pytest.raises(RuntimeError, match='stop after'):
            vega.get_collapsed(frozenset(NAMES))
        limits['bias_LYA'] = saved
    assert seen[0] != seen[1] and seen[0] == seen[2]


@pytest.fixture(scope='module')
def metal_port(tmp_path_factory):
    main = make_synthetic_dataset(
        tmp_path_factory.mktemp('metals'), cross=True, size='tiny',
        device='cpu', sample=SAMPLE, extra_model=dr16_extra_model(),
        metals=list(DR16_METALS))
    return VegaInterface(main, device='cpu')


@pytest.mark.parametrize('what', ['matrix', 'coordinates'])
def test_fingerprint_follows_metal_content(metal_port, what):
    """A metal matrix's content and a metal pair's coordinates: one entry
    changed by a part in 1e12 changes the fingerprint."""
    data = metal_port.data['lyaxlya']
    pair = sorted(data.metal_coordinates)[0]
    n = data.metal_coordinates[pair].rp_grid.size
    if what == 'matrix':
        data.metal_mats[pair] = np.eye(n)
        before = fingerprint(metal_port)
        data.metal_mats[pair] = np.eye(n)
        data.metal_mats[pair][0, 1] = 1e-12
    else:
        before = fingerprint(metal_port)
        data.metal_coordinates[pair].rp_grid[0] *= 1 + 1e-12
    assert fingerprint(metal_port) != before


def test_fingerprint_follows_new_metals_weights(tmp_path):
    """The new-metals weights are hashed by content: the same path with
    one weight changed gives another fingerprint."""
    main = make_synthetic_dataset(
        tmp_path, cross=True, size='tiny', device='cpu', sample=SAMPLE,
        extra_model=desi_extra_model(), metals=list(DESI_METALS),
        new_metals=True)
    vega = VegaInterface(main, device='cpu')
    before = fingerprint(vega)
    stack = tmp_path / 'delta_stack.fits'
    columns = dict(read_fits(stack)[1].columns)
    columns['WEIGHT'] = columns['WEIGHT'].copy()
    columns['WEIGHT'][7] *= 1.5
    write_fits(stack, [{'name': 'STACK', 'columns': columns}])
    assert fingerprint(vega) != before


def test_miss_sweeps_and_saves_then_a_hit_sweeps_nothing(
        tiny, tmp_path, monkeypatch, capsys):
    """A miss sweeps, saves the payload and removes its checkpoints; a
    second interface loads it without sweeping (the node sweep patched to
    raise) and serves a bit-equal chi^2; a corrupt entry warns and is
    swept and saved again."""
    cache = cache_in(monkeypatch, tmp_path)
    first = VegaInterface(tiny[0], device='cpu')
    first.get_collapsed(frozenset(NAMES))
    path = first.grid_stats['cache_path']
    assert first.grid_stats['source'] == 'sweep'
    assert os.listdir(cache) == [os.path.basename(path)]
    want = first.chi2_batch(batch())

    def no_sweep(*args, **kwargs):
        raise AssertionError('swept on a cache hit')

    with monkeypatch.context() as mp:
        mp.setattr(VegaInterface, '_grid_collapse_node', no_sweep)
        second = VegaInterface(tiny[0], device='cpu')
        assert torch.equal(second.chi2_batch(batch()), want)
    assert second.grid_stats['source'] == 'disk'

    with open(path, 'wb') as fh:
        fh.write(b'not an npz file')
    third = VegaInterface(tiny[0], device='cpu')
    assert torch.equal(third.chi2_batch(batch()), want)
    assert 'ignoring unreadable grid-payload cache entry' in \
        capsys.readouterr().out
    assert third.grid_stats['source'] == 'sweep'
    gc.load_payload(path)


def test_monte_carlo_mode_writes_nothing(tiny, tmp_path, monkeypatch):
    """In Monte-Carlo mode the payload bakes a mock in: it is swept and
    kept in memory only (vega_tpu/vega_interface.py:827-832)."""
    cache = cache_in(monkeypatch, tmp_path)
    vega = VegaInterface(tiny[0], device='cpu')
    vega.analysis.create_monte_carlo_sim(vega.compute_model(run_init=False),
                                         seed=3)
    vega.monte_carlo = True
    assert vega.get_collapsed(frozenset(NAMES))
    assert vega.grid_stats['source'] == 'sweep'
    assert 'cache_path' not in vega.grid_stats
    assert os.listdir(cache) == []


def test_port_payload_serves_jax(tiny, tmp_path, monkeypatch):
    """The port's cache entry, read with vega_tpu's load_payload, serves
    vega_tpu's chi^2 as it serves the port's (GRID_ABS + GRID_REL
    |chi2|)."""
    cache_in(monkeypatch, tmp_path)
    vega = VegaInterface(tiny[0], device='cpu')
    got = vega.chi2_batch(batch()).numpy()
    payload = jgc.load_payload(vega.grid_stats['cache_path'])
    jax_vega = JaxInterface(tiny[0])
    vecs = jax_vega._current_data_vecs()
    data_key = (jax_vega.monte_carlo,) + tuple(id(v) for v in vecs.values())
    jax_vega._grid_cache = {(frozenset(NAMES), data_key): payload}
    want = np.asarray(jax_vega.chi2_batch(batch()))
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))


def test_jax_payload_serves_the_port(tiny, tmp_path):
    """vega_tpu's payload, saved by vega_tpu and read by the port's
    load_payload, serves the port through use_grid_payload."""
    main, jax_vega = tiny
    jgc.save_payload(tmp_path / 'jax.npz', jax_vega.get_collapsed(NAMES))
    vega = VegaInterface(main, device='cpu')
    vega.use_grid_payload(NAMES, gc.load_payload(tmp_path / 'jax.npz'))
    got = vega.chi2_batch(batch()).numpy()
    want = np.asarray(jax_vega.chi2_batch(batch()))
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))


def test_interrupted_sweep_resumes(tiny, tmp_path, monkeypatch):
    """8 chunks of 8 nodes in groups of 2: a sweep cut at chunk 5 leaves
    the parts of groups 0 and 1; the retry sweeps chunks 4-7 only, its
    payload is bit-equal to an uninterrupted build's, and the parts are
    gone once it is saved."""
    monkeypatch.setenv('VEGA_TPU_GRID_SWEEP_CHUNK', '8')
    monkeypatch.setenv('VEGA_TPU_GRID_SWEEP_GROUP', '2')
    cache_in(monkeypatch, tmp_path / 'whole')
    whole = VegaInterface(tiny[0], device='cpu')
    whole.get_collapsed(frozenset(NAMES))
    want = gc.load_payload(whole.grid_stats['cache_path'])

    cache = cache_in(monkeypatch, tmp_path / 'cut')
    real = VegaInterface._grid_collapse_node
    calls = []

    def cut_at(k):
        def node(self, *args, **kwargs):
            if len(calls) == k:
                raise KeyboardInterrupt('cut')
            calls.append(1)
            return real(self, *args, **kwargs)
        return node

    monkeypatch.setattr(VegaInterface, '_grid_collapse_node', cut_at(5))
    with pytest.raises(KeyboardInterrupt):
        VegaInterface(tiny[0], device='cpu').get_collapsed(frozenset(NAMES))
    (entry,) = [p for p in cache.iterdir() if p.suffix == '.sweep']
    assert sorted(os.listdir(entry)) == ['part_000000_2x8.npz',
                                         'part_000002_2x8.npz']
    calls.clear()
    monkeypatch.setattr(VegaInterface, '_grid_collapse_node', cut_at(-1))
    retry = VegaInterface(tiny[0], device='cpu')
    retry.get_collapsed(frozenset(NAMES))
    assert len(calls) == 4
    assert not entry.exists()
    got = gc.load_payload(retry.grid_stats['cache_path'])
    assert repr(got['__grid__']) == repr(want['__grid__'])
    for name in ('lyaxlya', 'qsoxlya'):
        assert sorted(got[name]) == sorted(want[name])
        for part in want[name]:
            assert np.array_equal(got[name][part], want[name][part])
