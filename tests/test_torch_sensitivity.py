"""Fisher sensitivity in the PyTorch port against the JAX package
(vega_tpu), on the CPU at size='tiny', mirroring
tests/test_sensitivity.py: the exact partials (compute_sensitivity_exact,
forward-mode columns as one double backward) and the central
differences (compute_sensitivity) against vega_tpu's and against each
other, the exact partials through the kernel route, the sky-residual
names' exact partials that vega_tpu's component graph leaves at 0, and
set_fast_metals. Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from jax_dr16pub_dataset import (configuration_variant,  # noqa: E402
                                 make_jax_dr16_published_dataset)
from test_torch_derivatives import stub_kernels  # noqa: E402,F401
from vega_tpu.testing import make_synthetic_dataset  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch.testing import SKY_NAMES  # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

EXACT_RTOL = 1e-9       # exact partials, of the largest entry
FD_RTOL = 1e-8          # central differences, the same differences
FISHER_RTOL = 1e-8      # Fisher information, of its largest finite entry
KERNEL_RTOL = 1e-13     # the kernel route against the plain one
# the exact partials against the central differences (frac 0.01), as
# tests/test_sensitivity.py holds them
EXACT_VS_FD_ATOL, EXACT_VS_FD_FISHER = 1e-3, 2e-3
NOMINAL = {'bias_LYA': (-0.117, 0.01), 'beta_LYA': (1.67, 0.1),
           'ap': (1.0, 0.02), 'at': (1.0, 0.02)}


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def fisher_rel(got, want):
    """NaN outside the mask in the same places, elsewhere of the largest
    finite entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    mask = np.isfinite(want)
    return max_rel(got[mask], want[mask])


def snapshot(vega):
    return {kind: {corr: dict(values) for corr, values in
                   vega.sensitivity[kind].items()}
            for kind in ('partials', 'fisher')}


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield


@pytest.fixture(scope='module')
def sensitivities(tmp_path_factory):
    """The tiny auto + cross: each package's exact and finite-difference
    sensitivity at NOMINAL (frac 0.01), and the port's interface."""
    main = make_synthetic_dataset(tmp_path_factory.mktemp('auto_cross'),
                                  cross=True, size='tiny', noise=1.0)
    out = {}
    for package, vega in (('port', VegaInterface(main, device='cpu')),
                          ('jax', JaxInterface(main))):
        vega.compute_sensitivity_exact(nominal=NOMINAL, verbose=False)
        out[package, 'exact'] = snapshot(vega)
        vega.compute_sensitivity(nominal=NOMINAL, frac=0.01, verbose=False)
        out[package, 'fd'] = snapshot(vega)
        out[package] = vega
    return out


@pytest.mark.parametrize('kind,rtol', [('exact', EXACT_RTOL),
                                       ('fd', FD_RTOL)])
def test_sensitivity_matches_jax(sensitivities, kind, rtol):
    """Each partial (2 distorted / raw, 2 peak / smooth, bins) within
    rtol of vega_tpu's, each Fisher information within FISHER_RTOL."""
    got, want = sensitivities['port', kind], sensitivities['jax', kind]
    assert set(got['partials']) == set(want['partials'])
    for corr, partials in want['partials'].items():
        assert list(got['partials'][corr]) == list(partials)
        for name, partial in partials.items():
            assert partial.shape == (2, 2, partial.shape[-1])
            assert max_rel(got['partials'][corr][name], partial) <= rtol
        assert set(got['fisher'][corr]) == set(want['fisher'][corr])
        for pair, fisher in want['fisher'][corr].items():
            assert fisher_rel(got['fisher'][corr][pair], fisher) <= \
                FISHER_RTOL


def test_exact_matches_finite_differences(sensitivities):
    """The port's exact partials against its central differences, as
    tests/test_sensitivity.py holds vega_tpu's."""
    exact, fd = sensitivities['port', 'exact'], sensitivities['port', 'fd']
    for corr, partials in exact['partials'].items():
        for name, partial in partials.items():
            scale = np.max(np.abs(partial))
            np.testing.assert_allclose(fd['partials'][corr][name], partial,
                                       atol=EXACT_VS_FD_ATOL * scale)
        for pair, fisher in exact['fisher'][corr].items():
            other = fd['fisher'][corr][pair]
            mask = np.isfinite(other)
            np.testing.assert_allclose(
                other[mask], fisher[mask],
                atol=EXACT_VS_FD_FISHER * np.max(np.abs(fisher[mask])))


def test_exact_through_the_kernels(sensitivities, stub_kernels):
    """On the kernel route (stub kernels on the CPU) the exact partials
    launch the forward F_0, a kernel of order d >= 1 and the transpose,
    and equal the plain route's within KERNEL_RTOL."""
    port = sensitivities['port']
    port.compute_sensitivity_exact(nominal=NOMINAL, verbose=False)
    launched = {key for key, n in stub_kernels.items() if n}
    assert ('F', 0) in launched
    assert any(p in ('F', 'P') and d >= 1 for p, d in launched)
    assert any(p == 'Ft' for p, _ in launched)
    want = sensitivities['port', 'exact']['partials']
    for corr, partials in want.items():
        for name, partial in partials.items():
            assert max_rel(port.sensitivity['partials'][corr][name],
                           partial) <= KERNEL_RTOL


def test_nominal_needs_a_fit_as_jax(sensitivities):
    """Without a nominal and before a fit both packages refuse."""
    for package in ('port', 'jax'):
        vega = sensitivities[package]
        for method in (vega.compute_sensitivity_exact,
                       vega.compute_sensitivity):
            with pytest.raises(RuntimeError, match='No nominal'):
                method(verbose=False)


@pytest.fixture(scope='module')
def published_auto(tmp_path_factory):
    """The tiny published DR16 configuration with the components written,
    its LYA x LYA auto alone (the sky residual's, with five metals)."""
    main = make_jax_dr16_published_dataset(
        tmp_path_factory.mktemp('published'), size='tiny', components=True)
    return configuration_variant(main, tmp_path_factory.mktemp('auto'),
                                 names=('lyaxlya',))


@pytest.fixture(scope='module')
def published(published_auto):
    """published_auto: both packages' interfaces."""
    return {'port': VegaInterface(published_auto, device='cpu'),
            'jax': JaxInterface(published_auto)}


def test_sky_names_have_no_exact_partials_as_jax(published):
    """vega_tpu's exact component graph leaves the broadband out
    (vega_interface.py:1537-1576), so the sky residual's names have exact
    partials of 0, where the central differences of the saved
    components, broadband included, are not 0. The port reproduces both
    (ROADMAP.md section 3)."""
    sky = SKY_NAMES[0]                     # lyaxlya's scale
    nominal = {sky: (0.01, 0.001), 'beta_LYA': (1.669, 0.01)}
    results = {}
    for package, vega in published.items():
        vega.compute_sensitivity_exact(nominal=nominal, verbose=False)
        exact = snapshot(vega)['partials']
        vega.compute_sensitivity(nominal={sky: nominal[sky]}, verbose=False)
        results[package] = exact, snapshot(vega)['partials']
    for package, (exact, fd) in results.items():
        for corr in exact:
            assert not np.any(exact[corr][sky])
            assert np.any(exact[corr]['beta_LYA'])
        assert np.max(np.abs(fd['lyaxlya'][sky])) > 0
    assert max_rel(results['port'][0]['lyaxlya']['beta_LYA'],
                   results['jax'][0]['lyaxlya']['beta_LYA']) <= EXACT_RTOL
    assert max_rel(results['port'][1]['lyaxlya'][sky],
                   results['jax'][1]['lyaxlya'][sky]) <= FD_RTOL


def test_set_fast_metals_matches_jax(published_auto):
    """set_fast_metals turns fast metals on in every model's metals, as
    vega_tpu's does; the growth rate is not sampled, so the chi^2 stays
    the same."""
    point = {'bias_eta_LYA': -0.2, 'beta_LYA': 1.6}
    port, ref = VegaInterface(published_auto, device='cpu'), \
        JaxInterface(published_auto)
    before = port.chi2(point)
    for vega in (port, ref):
        assert not any(m.metals.fast_metals for m in vega.models.values())
        vega.set_fast_metals()
        assert all(m.metals.fast_metals for m in vega.models.values())
    assert abs(port.chi2(point) - before) <= 1e-12 * abs(before)
