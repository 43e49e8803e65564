"""The plots (vega_tpu_torch.plots) against the JAX package's
(vega_tpu.plots), on the CPU at size='tiny', mirroring tests/test_plots.py:
the wedge, shell and rt-wedge weight matrices and compressions, and the
lines the panel plots draw from the same model (`ax.lines[i].
get_xydata()`), each read off its own package's interface. The plots are
host numpy copies, so everything is held bit for bit."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from vega_tpu.plots import utils as jax_utils  # noqa: E402
from vega_tpu.plots.rt_wedges import RtWedge as JaxRtWedge  # noqa: E402
from vega_tpu.plots.shell import Shell as JaxShell  # noqa: E402
from vega_tpu.plots.wedges import Wedge as JaxWedge  # noqa: E402
from vega_tpu.testing import make_synthetic_dataset  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch.plots import utils  # noqa: E402
from vega_tpu_torch.plots.rt_wedges import RtWedge  # noqa: E402
from vega_tpu_torch.plots.shell import Shell  # noqa: E402
from vega_tpu_torch.plots.wedges import Wedge  # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

CORRELATIONS = ('lyaxlya', 'qsoxlya')


def same_lines(got, want):
    """Every axis of two figures draws the same lines, bit for bit."""
    assert len(got.axes) == len(want.axes)
    for ax_got, ax_want in zip(got.axes, want.axes):
        assert len(ax_got.lines) == len(ax_want.lines)
        assert ax_got.lines
        for line_got, line_want in zip(ax_got.lines, ax_want.lines):
            assert np.array_equal(line_got.get_xydata(),
                                  line_want.get_xydata(), equal_nan=True)
        assert ax_got.get_title() == ax_want.get_title()


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close('all')


@pytest.fixture(scope='module')
def interfaces(tmp_path_factory):
    """The tiny auto + cross read by each package, and vega_tpu's model
    at the defaults (the one both packages' plots draw)."""
    main = make_synthetic_dataset(tmp_path_factory.mktemp('plots'),
                                  cross=True, size='tiny', noise=1.0)
    ref = JaxInterface(main)
    return {'port': VegaInterface(main, device='cpu'), 'jax': ref,
            'model': ref.compute_model(run_init=False)}


@pytest.mark.parametrize('kwargs', [
    {'mu': (0.0, 1.0)}, {'mu': (0.5, 0.8), 'abs_mu': True},
    {'mu': (-1.0, -0.5), 'rp': (-200., 200., 100)}])
def test_wedge_matches_jax(kwargs):
    """Weights, bin centres and a compression with its covariance."""
    got, want = Wedge(**kwargs), JaxWedge(**kwargs)
    assert np.array_equal(got.weights, want.weights)
    rng = np.random.default_rng(0)
    data = rng.normal(size=got.weights.shape[1])
    cov = np.diag(rng.uniform(0.5, 2.0, data.size))
    for a, b in zip(got(data, cov), want(data, cov)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('kwargs', [
    {'r': (60, 90)}, {'r': (30, 45), 'angle_var': 'mu', 'abs_mu': True},
    {'r': (40, 60), 'angle_var': 'mu2', 'rp': (-200, 200, 100),
     'angle_range': (-1, 1)}])
def test_shell_matches_jax(kwargs):
    got, want = Shell(**kwargs), JaxShell(**kwargs)
    assert np.array_equal(got.weights, want.weights)
    assert np.array_equal(got.angle, want.angle)
    data = np.random.default_rng(1).normal(size=got.weights.shape[1])
    for a, b in zip(got(data), want(data)):
        assert np.array_equal(a, b)


def test_rt_wedge_matches_jax():
    got, want = RtWedge(rt_cut=(0., 8.0)), JaxRtWedge(rt_cut=(0., 8.0))
    assert np.array_equal(got.weights, want.weights)
    data = np.arange(got.weights.shape[1], dtype=float)
    for a, b in zip(got(data), want(data)):
        assert np.array_equal(a, b)


def test_plots_read_the_data_as_jax(interfaces):
    """VegaPlots' state from each package's data: the data vectors, the
    covariances as read, the scale cuts, masks and coordinate setups."""
    got, want = interfaces['port'].plots, interfaces['jax'].plots
    assert got.cross_flag == want.cross_flag
    for name in CORRELATIONS:
        for field in ('data', 'cov_mat', 'mask'):
            assert np.array_equal(getattr(got, field)[name],
                                  getattr(want, field)[name])
        assert got.cuts[name] == want.cuts[name]
        for field in ('rp_setup_model', 'rt_setup_model', 'r_setup_model',
                      'rp_setup_data', 'rt_setup_data', 'r_setup_data'):
            assert getattr(got, field)[name] == getattr(want, field)[name]


@pytest.mark.parametrize('name', CORRELATIONS)
def test_4wedges_match_jax(interfaces, name):
    """run_vega's wedge panels: data, model and shaded cuts."""
    model = interfaces['model'][name]
    figs = [interfaces[p].plots.plot_4wedges(
        models=[model], corr_name=name, mu_bin_labels=True,
        model_colors=['r']) for p in ('port', 'jax')]
    same_lines(*figs)


@pytest.mark.parametrize('name', CORRELATIONS)
def test_4shells_match_jax(interfaces, name):
    """run_vega's shell panels with their residual strips."""
    model = interfaces['model'][name]
    figs = [interfaces[p].plots.plot_4shells(model=model, corr_name=name)
            for p in ('port', 'jax')]
    same_lines(*figs)


def test_sensitivity_heatmap_matches_jax(interfaces):
    """plot_sensitivity of one Fisher map, the port's own sensitivity."""
    port = interfaces['port']
    port.compute_sensitivity_exact(
        nominal={'bias_LYA': (-0.117, 0.01)}, verbose=False)
    figs = [interfaces[p].plots.plot_sensitivity(
        port.sensitivity, 'lyaxlya', 'bias_LYA') for p in ('port', 'jax')]
    got, want = (fig.axes[0].images[0].get_array() for fig in figs)
    assert np.array_equal(np.ma.getdata(got), np.ma.getdata(want),
                          equal_nan=True)


def test_standalone_wedges_match_jax():
    """utils.plot_wedges (a 50 x 50 grid of its own): two models and the
    data with their covariance, auto and cross."""
    rng = np.random.default_rng(2)
    for cross, n_bins in ((False, 2500), (True, 5000)):
        models = [rng.normal(size=n_bins) for _ in range(2)]
        data = rng.normal(size=n_bins)
        cov = np.diag(rng.uniform(0.5, 2.0, n_bins))
        same_lines(*(helpers.plot_wedges(models, cov, multi_model=True,
                                         labels=['a', 'b'], data=data,
                                         cross=cross)
                     for helpers in (utils, jax_utils)))
