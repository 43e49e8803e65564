"""vega_tpu's reference-named drop-in surface in the PyTorch port, the
counterpart of tests/test_dropin_surface.py, on the CPU:

- PktoXi.Pk2Mp and pk_to_xi (the Hamilton-2000 path, old_fftlog's
  compute) against vega_tpu's PktoXi.Pk2Mp / pk_to_xi and the port's own
  old_fftlog compute; compute_xi_ell / compute_xi against vega_tpu's and
  the port's compute, with the VegaBoundsError out of range;
- the ScaleParameters statics against vega_tpu's, on floats and on (B,)
  tensors;
- utils: the growth re-exports, the error classes, the smoothing
  factors, convert_instance_to_dictionary and the inverse-covariance
  cache's budget (VEGA_TPU_INVCOV_CACHE_MB);
- the Metals views (compute_metal_corr_slow, compute_xi_metal_metal,
  compute_xi_metal_cross_main) against vega_tpu's views and the port's
  own compute_metal_corr and unrolled metal sum, and the
  CorrelationFunction views
  (init_bias_evol, compute_growth, compute_xi_relativistic,
  compute_xi_asymmetry, compute_desi_instrumental_systematics, uv_A)
  against the port's main path and vega_tpu's views, on the tiny
  synthetic-dr16-uv files (metals, UV shotnoise, the relativistic and
  asymmetry pair on the cross);
- the package's lazy exports, vega_tpu's eight names.

Held in f64 at RTOL (of the largest entry) unless stated otherwise."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vega_tpu.pktoxi import PktoXi as JaxPktoXi
from vega_tpu.scale_parameters import ScaleParameters as JaxScaleParameters
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import utils
from vega_tpu_torch.pktoxi import PktoXi
from vega_tpu_torch.scale_parameters import ScaleParameters
from vega_tpu_torch.testing import make_dr16_uv_dataset
from vega_tpu_torch.vega_interface import VegaInterface

RTOL = 1e-12
K = np.logspace(-4, 2, 512)
N_MUK = 60
MUK = ((np.arange(N_MUK) + 0.5) / N_MUK)[:, None]
R = np.linspace(10.0, 180.0, 50)
MU = np.linspace(0.0, 1.0, 50)


def max_rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, float)
    want = np.asarray(want.detach() if torch.is_tensor(want) else want,
                      float)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def model_config(**model):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['model'] = {str(key): str(val) for key, val in model.items()}
    return config['model']


def pktoxi_pair(**model):
    """(port PktoXi, vega_tpu PktoXi) on K and MUK with vega_tpu's default
    midpoint weights."""
    weights = np.full(N_MUK, 1.0 / N_MUK)
    return (PktoXi(K, MUK, weights, model_config(**model), device='cpu'),
            JaxPktoXi(K, MUK, 'LYA', 'LYA', model_config(**model)))


def smooth_pk(k, muk):
    kk = k[None, :] * np.ones_like(muk)
    return np.exp(-((np.log(kk) - np.log(0.08)) ** 2) / 2) \
        * (1 + 0.5 * muk ** 2)


@pytest.mark.parametrize('tform', [None, 'rel', 'asy'])
def test_pk2mp_matches_jax(tform):
    """Pk2Mp of each transform form against vega_tpu's PktoXi.Pk2Mp."""
    pk = smooth_pk(K, MUK)
    spec = pk if tform is None else pk[0]
    ells = {None: (0, 2, 4, 6), 'rel': (1, 3), 'asy': (0, 2)}[tform]
    got = PktoXi.Pk2Mp(R, K, spec, ells, MUK, 1.0 / N_MUK, tform=tform)
    want = JaxPktoXi.Pk2Mp(R, K, spec, ells, MUK, 1.0 / N_MUK, tform=tform)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert max_rel(got, want) <= RTOL


@pytest.mark.parametrize('multipole', [-1, 0, 2])
def test_pk_to_xi_is_old_fftlog_compute(multipole):
    """pk_to_xi against vega_tpu's, and the port's own old_fftlog compute
    (the same operators; with a multipole, its term without P_ell(mu))."""
    obj, jax_obj = pktoxi_pair()
    legacy, _ = pktoxi_pair(old_fftlog=True)
    pk = smooth_pk(K, MUK)
    got = obj.pk_to_xi(R, MU, pk, multipole=multipole)
    assert got.dtype == torch.float64 and got.shape == (len(R),)
    assert max_rel(got, np.asarray(jax_obj.pk_to_xi(
        R, MU, pk, multipole=multipole))) <= RTOL
    via_compute, oob = legacy.compute(
        torch.as_tensor(R), torch.as_tensor(MU),
        torch.as_tensor(pk), single_ell=multipole)
    assert not bool(oob.any())
    assert max_rel(got, via_compute[0]) <= RTOL


def test_compute_xi_ell_and_compute_xi_match_compute():
    """The per-multipole interpolators against vega_tpu's and, summed by
    compute_xi, against the port's compute; 0 at r = 0; VegaBoundsError
    out of the knot range."""
    obj, jax_obj = pktoxi_pair()
    pk = smooth_pk(K, MUK)
    interp = obj.compute_xi_ell(pk, obj.ell_vals, 'cache', 'pars')
    jax_interp = jax_obj.compute_xi_ell(pk, jax_obj.ell_vals)
    assert set(interp) == set(jax_interp) == set(obj.ell_vals)
    for ell in obj.ell_vals:
        assert max_rel(interp[ell](np.log(R)),
                       jax_interp[ell](np.log(R))) <= RTOL
    via_split = obj.compute_xi(interp, R, MU)
    direct, oob = obj.compute(torch.as_tensor(R), torch.as_tensor(MU),
                              torch.as_tensor(pk))
    assert not bool(oob.any())
    assert max_rel(via_split, direct[0]) <= RTOL
    assert max_rel(via_split, jax_obj.compute_xi(jax_interp, R, MU)) <= RTOL
    assert obj.compute_xi(interp, np.r_[0.0, R], np.r_[0.5, MU])[0] == 0.0
    with pytest.raises(utils.VegaBoundsError):
        interp[0](np.log(1e30))
    assert issubclass(utils.VegaBoundsError, utils.VegaModelError)


def scale_pair(**options):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['cosmo-fit type'] = {str(k): str(v) for k, v in options.items()}
    return (ScaleParameters(config['cosmo-fit type']),
            JaxScaleParameters(config['cosmo-fit type']))


SCALE_VALUES = {'ap': 1.04, 'at': 0.97, 'aiso': 1.02, 'epsilon': 0.01,
                'phi': 0.95, 'alpha': 1.03, 'ap_full': 1.1, 'at_full': 0.9,
                'phi_full': 0.9, 'peak': True}


@pytest.mark.parametrize('batched', [False, True])
def test_scale_parameters_statics_match_jax(batched):
    """default, ap_at, aiso_epsilon, phi_alpha, get_bao_params,
    get_fullshape_params and get_fullshape_phi_alpha against vega_tpu's
    on the same values (floats, or (3,) tensors around them)."""
    values = dict(SCALE_VALUES)
    if batched:
        values = {k: (v if k == 'peak' else
                      torch.tensor([v, 1.01 * v, 0.99 * v],
                                   dtype=torch.float64))
                  for k, v in values.items()}
    jax_values = {k: (np.asarray(v) if torch.is_tensor(v) else v)
                  for k, v in values.items()}

    def same(got, want):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert max_rel(np.atleast_1d(np.asarray(g, float)),
                           np.atleast_1d(np.asarray(w, float))) <= RTOL

    sp, jsp = scale_pair()
    assert sp.default() == jsp.default() == (1.0, 1.0)
    for name in ('ap_at', 'aiso_epsilon', 'phi_alpha'):
        same(getattr(sp, name)(values), getattr(jsp, name)(jax_values))
    for name in ('ap_at', 'aiso_epsilon', 'phi_alpha'):
        sp, jsp = scale_pair(**{'cosmo fit func': name})
        same(sp.get_bao_params(values), jsp.get_bao_params(jax_values))
        same(sp.get_bao_params(values), sp.get_ap_at(values))
    sp, jsp = scale_pair(**{'full-shape': True, 'full-shape-alpha': True})
    same(sp.get_fullshape_params(values),
         jsp.get_fullshape_params(jax_values))
    same(sp.get_fullshape_params(values), sp.get_ap_at(values))
    for sp in scale_pair(**{'full-shape': True}):
        with pytest.raises(ValueError):
            sp.get_fullshape_params(values)
    sp, jsp = scale_pair(**{'full-shape': True,
                            'cosmo fit func': 'phi_alpha'})
    same(sp.get_fullshape_phi_alpha(values),
         jsp.get_fullshape_phi_alpha(jax_values))
    same(sp.get_fullshape_phi_alpha(values), sp.get_ap_at(values))


def test_utils_names_match_jax():
    """The growth re-exports are the port's cosmo functions and give
    vega_tpu's values; the error classes; the smoothing factors and
    convert_instance_to_dictionary as vega_tpu's."""
    from vega_tpu import utils as jax_utils
    from vega_tpu_torch import cosmo
    for name in ('growth_function', 'get_growth_interp', 'hubble',
                 'growth_integrand'):
        assert getattr(utils, name) is getattr(cosmo, name)
    assert max_rel(utils.growth_function(np.array([2.33, 3.1]), 0.31457,
                                         1 - 0.31457),
                   jax_utils.growth_function(np.array([2.33, 3.1]),
                                             0.31457, 1 - 0.31457)) <= RTOL
    assert max_rel(utils.hubble(2.33, 0.31457, 1 - 0.31457),
                   jax_utils.hubble(2.33, 0.31457, 1 - 0.31457)) <= RTOL
    for name in ('VegaBoundsError', 'VegaArinyoError'):
        cls = getattr(utils, name)
        assert issubclass(cls, utils.VegaModelError)
        assert cls.__name__ == getattr(jax_utils, name).__name__
    kp, kt = np.meshgrid(np.linspace(0, 1, 7), np.linspace(0, 2, 5))
    assert max_rel(utils.compute_gauss_smoothing(3.1, 2.2, kp, kt),
                   jax_utils.compute_gauss_smoothing(3.1, 2.2, kp, kt)) \
        <= RTOL
    assert max_rel(utils.compute_kn_smoothing(2.5, kp, 3),
                   jax_utils.compute_kn_smoothing(2.5, kp, 3)) <= RTOL

    class Holder:
        a, b = 1, 'two'

        def method(self):
            return 3
    inst = Holder()
    got = utils.convert_instance_to_dictionary(inst)
    want = jax_utils.convert_instance_to_dictionary(inst)
    assert set(got) == set(want) and got['a'] == 1 and got['b'] == 'two'


def test_invcov_cache_budget(monkeypatch):
    """VEGA_TPU_INVCOV_CACHE_MB sets the inverse-covariance cache's
    budget as vega_tpu's does: 0 holds nothing, the default holds the
    inverse (the same read-only array on the second call)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 40))
    cov = a @ a.T + 40 * np.eye(40)
    mask = np.ones(40, dtype=bool)
    mask[::7] = False
    monkeypatch.setattr(utils, '_INVCOV_CACHE', {})
    monkeypatch.setenv('VEGA_TPU_INVCOV_CACHE_MB', '0')
    first = utils.compute_masked_invcov(cov, mask)
    assert utils._INVCOV_CACHE == {}
    assert utils.compute_masked_invcov(cov, mask) is not first
    monkeypatch.delenv('VEGA_TPU_INVCOV_CACHE_MB')
    first = utils.compute_masked_invcov(cov, mask)
    assert utils.compute_masked_invcov(cov, mask) is first
    assert not first.flags.writeable
    assert max_rel(first, np.linalg.inv(cov[np.ix_(mask, mask)])) <= 1e-12


# ----------------------------------------------------------------------
# The Metals and CorrelationFunction views, on tiny synthetic-dr16-uv
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def uv(tmp_path_factory):
    """(port interface, vega_tpu interface) on the tiny synthetic-dr16-uv
    files, both dense."""
    main = make_dr16_uv_dataset(tmp_path_factory.mktemp('dropin_uv'),
                                size='tiny', device='cpu')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        return VegaInterface(main, device='cpu'), JaxInterface(main)


def metal_pars(vega, model):
    pars, _ = vega._batch_params(None)
    pars['peak'] = False
    return model.metals._local_pars(pars)


def jax_metal_pars(ref, metals):
    """vega_tpu's parameters as its Metals.compute hands them to a pair
    (vega_tpu/metals.py:553-557, with vega_tpu/model.py:229's peak)."""
    pars = dict(ref._get_lcl_prms(None))
    pars['peak'] = False
    if (metals.fast_metals and 'growth_rate' in pars
            and metals.growth_rate is not None):
        pars['growth_rate'] = metals.growth_rate
    return pars


def same_row(got, want):
    """max_rel of the port's (1, n) row against vega_tpu's (n,) vector."""
    want = np.asarray(want)
    return max_rel(got, want[None] if got.dim() == want.ndim + 1 else want)


@pytest.mark.parametrize('corr', ['lyaxlya', 'qsoxlya'])
def test_metal_views_are_the_pair_computation(uv, corr):
    """Each pair's views against vega_tpu's views on the same files (both
    bias modes, with and without the metal matrix), and bit for bit
    against the port's compute_metal_corr; the fast-bias sum of the
    metal-metal views against the unrolled metal stack."""
    vega, ref = uv
    model = vega.models[corr]
    metals, jax_metals = model.metals, ref.models[corr].metals
    pars = metal_pars(vega, model)
    jax_pars = jax_metal_pars(ref, jax_metals)
    pk_lin, jax_pk = vega._pk_full, ref.fiducial['pk_full']
    total = 0.
    for corr_hash in model._corr_item.metal_correlations:
        for fast in (False, True):
            for dmat in (True, False):
                got = metals.compute_metal_corr_slow(
                    pars, pk_lin, corr_hash, fast, add_metal_dmat=dmat)
                assert same_row(got, jax_metals.compute_metal_corr_slow(
                    jax_pars, jax_pk, corr_hash, fast,
                    add_metal_dmat=dmat)) <= RTOL
                assert torch.equal(got, metals.compute_metal_corr(
                    pars, pk_lin, corr_hash, fast,
                    add_metal_dmat=dmat)[0])
        raw = metals.compute_metal_corr_slow(pars, pk_lin, corr_hash, False,
                                             add_metal_dmat=False)
        assert torch.equal(
            metals.apply_metal_matrix(raw, corr_hash),
            metals.compute_metal_corr_slow(pars, pk_lin, corr_hash, False))
        fast = metals.compute_xi_metal_metal(pk_lin, pars, corr_hash)
        assert same_row(fast, jax_metals.compute_xi_metal_metal(
            jax_pk, jax_pars, corr_hash)) <= RTOL
        assert torch.equal(fast, metals.compute_metal_corr(
            pars, pk_lin, corr_hash, True)[0])
        cross_main = metals.compute_xi_metal_cross_main(
            pk_lin, pars, corr_hash, 1.0, 1.0)
        assert same_row(cross_main, jax_metals.compute_xi_metal_cross_main(
            jax_pk, jax_pars, corr_hash, 1.0, 1.0)) <= RTOL
        assert torch.equal(cross_main, fast)
        b1, _, b2, _ = utils.bias_beta(pars, *corr_hash)
        total = total + b1 * b2 * fast
    metals.fast_metal_bias = True
    try:
        unrolled, _ = metals.compute_unrolled(dict(pars), pk_lin)
    finally:
        metals.fast_metal_bias = False
    assert max_rel(total, unrolled) <= RTOL


def test_correlation_views_match_jax(uv):
    """init_bias_evol, compute_growth, compute_xi_relativistic,
    compute_xi_asymmetry, compute_desi_instrumental_systematics and uv_A
    of the port's CorrelationFunction against vega_tpu's views on the
    same files, and the first two against what the port's model uses."""
    vega, ref = uv
    for corr in ('lyaxlya', 'qsoxlya'):
        xi, jax_xi = vega.models[corr].Xi_core, ref.models[corr].Xi_core
        assert max_rel(xi.compute_growth(), xi.xi_growth) <= RTOL
        assert max_rel(xi.compute_growth(), jax_xi.compute_growth()) <= RTOL
        z = np.array([2.0, 2.4, 3.1])
        assert max_rel(xi.compute_growth(z, 2.3, 0.3, 0.7),
                       jax_xi.compute_growth(z, 2.3, 0.3, 0.7)) <= RTOL
        evol = (xi._rel_z_evol.clone(), xi._split_evol)
        xi.init_bias_evol(xi._tracer1['type'], xi._tracer2['type'])
        assert torch.equal(xi._rel_z_evol, evol[0])
        assert xi._split_evol is None
        taus = np.array([0.005, 0.3, 2.0, 4.9, 6.0])
        assert max_rel(xi.uv_A(taus), np.asarray(jax_xi.uv_A(taus))) <= RTOL
    pars, _ = vega._batch_params(None)
    jax_pars = ref._get_lcl_prms(None)
    bin_size = vega.corr_items['lyaxlya'].data_coordinates.rp_binsize
    for flag in (False, True):
        pars['peak'] = jax_pars['peak'] = flag
        auto, jax_auto = (vega.models['lyaxlya'].Xi_core,
                          ref.models['lyaxlya'].Xi_core)
        got = auto.compute_desi_instrumental_systematics(pars, bin_size)
        assert bool(got.any())
        assert max_rel(got, np.asarray(
            jax_auto.compute_desi_instrumental_systematics(
                jax_pars, bin_size))) <= RTOL
        model, jax_model = vega.models['qsoxlya'], ref.models['qsoxlya']
        for name in ('compute_xi_relativistic', 'compute_xi_asymmetry'):
            got = getattr(model.Xi_core, name)(vega._pk_full, model.PktoXi,
                                               pars)
            want = np.asarray(getattr(jax_model.Xi_core, name)(
                ref.fiducial['pk_full'], jax_model.PktoXi, jax_pars))
            assert max_rel(got, want[None]) <= 1e-10
    with pytest.raises(AssertionError):
        vega.models['lyaxlya'].Xi_core.compute_xi_relativistic(
            vega._pk_full, vega.models['lyaxlya'].PktoXi, pars)


def test_lazy_exports():
    """vega_tpu's eight names, each resolved at first access from the
    port's module of the same role; importing the package imports none of
    them (in a fresh process that blocks JAX)."""
    import vega_tpu
    import vega_tpu_torch
    assert vega_tpu_torch.__all__ == list(vega_tpu._EXPORTS)
    for name in vega_tpu_torch.__all__:
        obj = getattr(vega_tpu_torch, name)
        assert obj.__name__ == name
        assert obj.__module__ == vega_tpu_torch._EXPORTS[name]
    with pytest.raises(AttributeError):
        vega_tpu_torch.NotAName
    code = ("import sys; sys.modules['jax'] = None\n"
            "import vega_tpu_torch\n"
            "assert 'vega_tpu_torch.vega_interface' not in sys.modules\n"
            "vega_tpu_torch.VegaInterface\n"
            "assert 'vega_tpu_torch.vega_interface' in sys.modules\n")
    subprocess.run([sys.executable, '-c', code], check=True,
                   cwd=Path(__file__).resolve().parents[1])
