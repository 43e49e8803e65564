"""The new-metals distortion matrices of the PyTorch port
(vega_tpu_torch/metals.py, native/pair_hist.py) against the JAX package
(vega_tpu) on the CPU: the port's numpy route against vega_tpu's numpy
route, the port's C++ pair histograms against the port's numpy route and
against the pair algebra written out, the rp-only form, and a g++ build
that fails. Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser

import numpy as np
import pytest
import torch

import vega_tpu.native.pair_hist as jax_ph
from vega_tpu.coordinates import Coordinates as JaxCoordinates
from vega_tpu.cosmo import Cosmo as JaxCosmo
from vega_tpu.io.fits import write_fits
from vega_tpu.metals import Metals as JaxMetals
from vega_tpu_torch.coordinates import Coordinates
from vega_tpu_torch.cosmo import Cosmo
from vega_tpu_torch.metals import Metals
from vega_tpu_torch.native import pair_hist

NUMPY_RTOL = 1e-12      # port's numpy route vs vega_tpu's: same algebra
NATIVE_RTOL, NATIVE_ATOL = 1e-8, 1e-10   # C++ vs numpy (vega_tpu's own)
PAIR_RTOL = 1e-9        # the pair histograms vs the algebra written out


class FakeCorrItem:
    pass


def weights_files(tmp_path):
    """A stacked-delta weights file (LOGLAM, WEIGHT) and a QSO catalogue
    (Z), small and seeded."""
    rng = np.random.default_rng(3)
    wave = np.linspace(3600, 4800, 600)
    stack = tmp_path / 'delta_stack.fits'
    write_fits(stack, [{'name': 'STACK', 'columns': {
        'LOGLAM': np.log10(wave), 'WEIGHT': rng.uniform(0.5, 2.0, 600)}}])
    catalog = tmp_path / 'qso_catalog.fits'
    write_fits(catalog, [{'name': 'CAT', 'columns': {
        'Z': rng.uniform(1.8, 4.0, 20_000)}}])
    return stack, catalog


def make_metals(cls, coordinates, cosmo, tmp_path, cross):
    """A Metals of either package with only what the matrix builders
    read (as tests/test_new_metals.py builds vega_tpu's)."""
    stack, catalog = weights_files(tmp_path)
    config = configparser.ConfigParser()
    config.optionxform = lambda o: o
    config['metal-matrix'] = {
        'rebin_factor': '2', 'alpha_LYA': '2.9', 'alpha_SiII(1190)': '1.',
        'alpha_SiIII(1207)': '1.', 'alpha_SiII(1260)': '1.',
        'z_bins_objects': '300'}
    item = FakeCorrItem()
    types = ('discrete', 'continuous') if cross else ('continuous',) * 2
    item.tracer1 = {'name': 'QSO' if cross else 'LYA', 'type': types[0],
                    'weights-path': str(catalog if cross else stack)}
    item.tracer2 = {'name': 'LYA', 'type': types[1],
                    'weights-path': str(stack)}
    metals = cls.__new__(cls)
    metals._corr_item = item
    metals.cosmo = cosmo(Om=0.315)
    n_rp = 20 if cross else 10
    metals._coordinates = coordinates(-200. if cross else 0., 200., 200.,
                                      n_rp, 10)
    metals.zmin, metals.zmax = 0.0, 10.0
    metals.main_tracers = [item.tracer1['name'], 'LYA']
    metals.main_tracer_types = list(types)
    metals.is_auto_correlation = not cross
    metals.metal_matrix_config = config['metal-matrix']
    metals.rp_nbins, metals.rt_nbins = n_rp, 10
    return metals


CASES = [(False, 'compute_metal_dmat', ('SiIII(1207)', 'LYA')),
         (False, 'compute_metal_dmat', ('SiII(1190)', 'SiII(1260)')),
         (False, 'compute_metal_rp_dmat', ('SiII(1190)', 'LYA')),
         (True, 'compute_metal_dmat', ('QSO', 'SiIII(1207)')),
         (True, 'compute_metal_rp_dmat', ('QSO', 'SiII(1260)'))]
IDS = ['auto-full-lya', 'auto-full-metals', 'auto-rp', 'cross-full',
       'cross-rp']


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('cross,method,pair', CASES, ids=IDS)
def test_numpy_route_matches_jax(tmp_path, monkeypatch, cross, method,
                                 pair):
    """The matrix and the effective (rp, rt, z) coordinates of the port's
    numpy route equal vega_tpu's numpy route (its C++ library withheld,
    as tests/test_new_metals.py:78-79 does), NUMPY_RTOL of each array's
    largest entry."""
    monkeypatch.setattr(jax_ph, '_LIB', None)
    monkeypatch.setattr(jax_ph, '_TRIED', True)
    want = getattr(make_metals(JaxMetals, JaxCoordinates, JaxCosmo,
                               tmp_path, cross), method)(*pair)
    got = getattr(make_metals(Metals, Coordinates, Cosmo, tmp_path, cross),
                  method)(*pair, route='numpy')
    assert len(got) == len(want) == 4
    assert got[0].shape == want[0].shape
    assert np.max(np.abs(want[0])) > 0
    for g, w in zip(got, want):
        assert max_rel(g, w) <= NUMPY_RTOL


@pytest.mark.parametrize('cross,method,pair', CASES, ids=IDS)
def test_native_route_matches_numpy(tmp_path, cross, method, pair):
    """The port's C++ pair histograms give the numpy route's matrix and
    coordinates to vega_tpu's own tolerance (parallel summation order)."""
    metals = make_metals(Metals, Coordinates, Cosmo, tmp_path, cross)
    got = getattr(metals, method)(*pair)
    want = getattr(metals, method)(*pair, route='numpy')
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=NATIVE_RTOL, atol=NATIVE_ATOL)


def test_unknown_route_raises(tmp_path):
    metals = make_metals(Metals, Coordinates, Cosmo, tmp_path, False)
    with pytest.raises(ValueError, match='route'):
        metals.compute_metal_dmat('SiIII(1207)', 'LYA', route='jax')


@pytest.mark.parametrize('abs_rp', [0, 1])
def test_pair_histograms_match_the_pair_algebra(abs_rp):
    """pair_histograms against the pairs written out in numpy
    (vega_tpu/metals.py:754-818; tests/test_native_pair_hist.py for
    vega_tpu's copy), and pair_ratio_range against the ratios' range."""
    rng = np.random.default_rng(7)
    n1, n2 = 300, 200
    true_z1, true_z2 = rng.uniform(1.8, 3.5, n1), rng.uniform(1.8, 3.5, n2)
    assumed_z1 = true_z1 * rng.uniform(0.97, 1.03, n1)
    assumed_z2 = true_z2 * rng.uniform(0.97, 1.03, n2)
    w1, w2 = rng.uniform(0, 2, n1), rng.uniform(0, 2, n2)

    def dist(z):
        return 3000 * np.log(1 + z)

    tr = (dist(true_z1)[:, None] - dist(true_z2)[None, :]).ravel()
    ar = (dist(assumed_z1)[:, None] - dist(assumed_z2)[None, :]).ravel()
    if abs_rp:
        tr, ar = np.abs(tr), np.abs(ar)
    zpair = ((assumed_z1[:, None] + assumed_z2[None, :]) / 2).ravel()
    w = (w1[:, None] * w2[None, :]).ravel() * ((zpair >= 2.0)
                                               & (zpair <= 3.2))
    true_md = ((dist(true_z1)[:, None] + dist(true_z2)[None, :]) / 2).ravel()
    assumed_md = ((dist(assumed_z1)[:, None]
                   + dist(assumed_z2)[None, :]) / 2).ravel()
    rp_edges = np.linspace(-200, 200, 101)
    ratio_edges = np.linspace(0.9, 1.1, 41)
    zmean = ((true_z1[:, None] + true_z2[None, :]) / 2).ravel()
    want = (
        np.histogram2d(ar, tr, bins=(rp_edges, rp_edges), weights=w)[0],
        np.histogram(tr, bins=rp_edges, weights=w)[0],
        np.histogram(ar, bins=rp_edges, weights=w)[0],
        np.histogram(ar, bins=rp_edges, weights=w * ar)[0],
        np.histogram(ar, bins=rp_edges, weights=w * zmean)[0],
        np.histogram(assumed_md / true_md, bins=ratio_edges,
                     weights=w / true_md ** 2 * (np.abs(tr) < 20.))[0])
    got = pair_hist.pair_histograms(
        dist(true_z1), dist(assumed_z1), true_z1, assumed_z1, w1,
        dist(true_z2), dist(assumed_z2), true_z2, assumed_z2, w2,
        abs_rp, 2.0, 3.2, rp_edges, ratio_edges)
    for g, h in zip(got, want):
        np.testing.assert_allclose(g, h, rtol=PAIR_RTOL, atol=PAIR_RTOL)
    lo, hi = pair_hist.pair_ratio_range(dist(true_z1), dist(assumed_z1),
                                        dist(true_z2), dist(assumed_z2))
    ratio = assumed_md / true_md
    assert (lo, hi) == pytest.approx((ratio.min(), ratio.max()), rel=1e-14)


def test_apply_rp_only_matrix(tmp_path):
    """The rp-only form acts along the line of sight of the (rp, rt) grid:
    D @ xi.reshape(rp, rt), flattened (vega_tpu/metals.py:607-611), on
    one row and on a batch of rows alike; the full form is xi @ D^T."""
    metals = make_metals(Metals, Coordinates, Cosmo, tmp_path, False)
    metals.device = torch.device('cpu')
    metals.new_metals = True
    rng = np.random.default_rng(1)
    rp_mat = torch.as_tensor(rng.normal(size=(10, 10)))
    full_mat = torch.as_tensor(rng.normal(size=(100, 100)))
    xi = torch.as_tensor(rng.normal(size=(3, 100)))
    pair = ('SiII(1190)', 'LYA')
    metals._metal_mats = {pair: rp_mat}
    metals.rp_only_metal_mats = True
    want = np.stack([(rp_mat.numpy() @ row.reshape(10, 10)).ravel()
                     for row in xi.numpy()])
    assert max_rel(metals.apply_metal_matrix(xi, pair), want) <= 1e-15
    assert max_rel(metals.apply_metal_matrix(xi[1], pair), want[1]) <= 1e-15
    metals._metal_mats = {pair: full_mat}
    metals.rp_only_metal_mats = False
    assert max_rel(metals.apply_metal_matrix(xi, pair),
                   xi.numpy() @ full_mat.numpy().T) <= 1e-15


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses, or no g++ at all, raises RuntimeError: the
    matrices never fall back to numpy unasked."""
    broken = tmp_path / 'pair_hist.cpp'
    broken.write_text('this is not C++\n')
    monkeypatch.setattr(pair_hist, 'SOURCE', broken)
    monkeypatch.setattr(pair_hist, 'BUILD_DIR', tmp_path / 'build')
    pair_hist.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
            pair_hist.load_library()
        monkeypatch.setattr(pair_hist.shutil, 'which', lambda name: None)
        with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
            pair_hist.load_library()
        metals = make_metals(Metals, Coordinates, Cosmo, tmp_path, False)
        with pytest.raises(RuntimeError, match='g\\+\\+'):
            metals.compute_metal_dmat('SiIII(1207)', 'LYA')
    finally:
        pair_hist.load_library.cache_clear()
