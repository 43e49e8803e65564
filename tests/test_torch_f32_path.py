"""The f32 throughput mode of the PyTorch port (VegaInterface(..., dtype=
torch.float32) or VEGA_TPU_X64=0) on the CPU, held within vega_tpu's f32
ladder (tests/test_f32_mode.py:106-109: |d chi2| <= 0.3 and <= 3e-4
|chi2|, both held there on chi^2 of ~200-3,300, where the two parts meet
at chi^2 = 1,000): here |d chi2| <= max(0.3, 3e-4 |chi2|), the absolute
part below 1,000 and the relative part above it (at chi^2 = 73,016 the
JAX package's own f32 misses its f64 by 0.68, the port's by 0.61); best
fits within 1e-2 of the JAX errors:

- synthetic-full's dense chi^2 against the JAX package's f32 goldens
  (tests/data/torch_port_f32_goldens.json, made by
  tests/tools/make_torch_port_f32_goldens.py under VEGA_TPU_X64=0) and
  against its f64 chi^2 there;
- on the tiny dataset with (ap, at, bias_LYA, beta_LYA) sampled and 8 x 8
  grid nodes: the dense and grid chi^2 and value and gradient against
  the port's f64, both fits against the truth, with no f64 tensor on the
  path;
- the dtype's selection, TF32 off, the payload cache's separation of the
  dtypes, the penalty (inf in f32, as vega_tpu's 1e100 rounds) and the
  options and terms it once refused, each now a finite f32 result within
  the ladder of the f64 interface (the eBOSS DR16 and DESI
  configurations: tests/test_torch_f32_models.py; the samplers, scans and
  Monte-Carlo campaigns: tests/test_torch_f32_campaigns.py; the mocks'
  and the reference's own model terms: tests/test_torch_f32_terms.py;
  the likelihood options: tests/test_torch_f32_options.py).

The grid chi^2 and both fits of synthetic-full run against the goldens on
the card (chip_smoke.py's f32 phase): the 1,024-node sweep alone takes
minutes on the CPU.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.testing import make_synthetic_dataset
from vega_tpu_torch.utils import resolve_dtype
from vega_tpu_torch.vega_interface import PENALTY_CHI2, VegaInterface

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from make_torch_port_f32_options_goldens import with_rmin_cut  # noqa: E402
from make_torch_port_fit_goldens import SAMPLE  # noqa: E402

GOLDENS = Path(__file__).parent / 'data' / 'torch_port_f32_goldens.json'
LADDER_ABS, LADDER_REL = 0.3, 3e-4
# model_pk's f32 multipoles against the f64 interface's, of max|f64|
MULTIPOLE_RTOL = 1e-5
FIT_SIGMA = 1e-2
NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
# points inside the tiny configuration's node domain (ap, at in [0.77,
# 1.27] around the [sample] start)
POINTS = {'ap': [1.01, 1.03, 0.96, 1.1], 'at': [0.99, 0.98, 1.05, 0.9],
          'bias_LYA': [-0.117, -0.12, -0.11, -0.125],
          'beta_LYA': [1.67, 1.7, 1.62, 1.58]}
# the dataset's truth: make_synthetic_dataset writes the model at the
# defaults
TRUTH = {'ap': 1.0, 'at': 1.0, 'bias_LYA': -0.117, 'beta_LYA': 1.67}


def ladder(got, want):
    """(max |d chi2|, max |d chi2| / |chi2|)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    d = np.abs(got - want)
    return float(d.max()), float(np.max(d / np.abs(want)))


def within_ladder(got, want):
    """|d chi2| <= max(LADDER_ABS, LADDER_REL |chi2|) at every point."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return bool(np.all(np.abs(got - want) <= np.maximum(
        LADDER_ABS, LADDER_REL * np.abs(want))))


class F64Ops(TorchDispatchMode):
    """Counts the ATen ops that produce a float64 tensor while open."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                self.seen[str(func)] = self.seen.get(str(func), 0) + 1
        return out


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_X64', raising=False)
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield mp


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """main.ini of the tiny dataset, SAMPLE sampled, 8 x 8 grid nodes."""
    return make_synthetic_dataset(
        tmp_path_factory.mktemp('f32'), cross=True, size='tiny',
        sample=SAMPLE, device='cpu',
        extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n')


@pytest.fixture(scope='module')
def interfaces(tiny, env):
    """{(regime, dtype): interface} on the tiny dataset."""
    out = {}
    for regime, factored in (('dense', '0'), ('grid', '1')):
        env.setenv('VEGA_TPU_FACTORED', factored)
        for dtype in (torch.float32, torch.float64):
            out[regime, dtype] = VegaInterface(tiny, device='cpu',
                                               dtype=dtype)
    env.delenv('VEGA_TPU_FACTORED')
    return out


def test_full_dense_matches_jax_f32_goldens(env, tmp_path):
    """synthetic-full's dense chi^2 in f32 against vega_tpu's f32
    (measured 0.078, 1.0e-5 relative at most) and against its f64 (the
    port's f64 equals it to 1e-8, tests/test_torch_interface.py;
    measured 0.61 at chi^2 = 73,016, 4.2e-5 relative at most)."""
    goldens = json.loads(GOLDENS.read_text())
    main = make_synthetic_dataset(tmp_path, cross=True, size='full',
                                  sample=SAMPLE, device='cpu')
    env.setenv('VEGA_TPU_FACTORED', '0')
    f32 = VegaInterface(main, device='cpu', dtype=torch.float32)
    got = f32.chi2_batch(goldens['params'])
    env.delenv('VEGA_TPU_FACTORED')
    assert got.dtype == torch.float32
    assert within_ladder(got.numpy(), goldens['chi2_dense'])
    assert within_ladder(got.numpy(), goldens['chi2_dense_f64'])


@pytest.mark.parametrize('regime', ['dense', 'grid'])
def test_chi2_batch_matches_f64(interfaces, regime):
    """Measured: dense 0.015 (4.9e-5 relative), grid 0.009 (5.8e-5)."""
    got = interfaces[regime, torch.float32].chi2_batch(POINTS)
    want = interfaces[regime, torch.float64].chi2_batch(POINTS)
    assert got.dtype == torch.float32 and want.dtype == torch.float64
    assert within_ladder(got.numpy(), want.numpy())


@pytest.mark.parametrize('regime', ['dense', 'grid'])
def test_no_f64_tensor_on_the_path(interfaces, regime):
    """chi2_batch, the value and gradient and the Hessian of an f32
    interface make no float64 tensor (the grid's payload built before)."""
    vega = interfaces[regime, torch.float32]
    vega.chi2_batch(POINTS)
    point = {k: v[1] for k, v in POINTS.items()}
    with F64Ops() as ops:
        vega.chi2_batch(POINTS)
        vega.chi2_value_and_gradient(point)
        vega.chi2_hessian(point, list(NAMES))
    assert ops.seen == {}


@pytest.mark.parametrize('regime', ['dense', 'grid'])
def test_value_and_gradient_match_f64(interfaces, regime):
    """The value within the ladder (measured 3.1e-3 dense, 1.6e-3 grid)
    and the gradient within 1e-4 of its largest entry (measured 1.0e-5,
    1.1e-5)."""
    point = {k: v[1] for k, v in POINTS.items()}
    v32, g32 = interfaces[regime, torch.float32].chi2_value_and_gradient(
        point)
    v64, g64 = interfaces[regime, torch.float64].chi2_value_and_gradient(
        point)
    assert within_ladder([v32], [v64])
    g32, g64 = np.array([g32[n] for n in NAMES]), np.array(
        [g64[n] for n in NAMES])
    assert np.max(np.abs(g32 - g64)) <= 1e-4 * np.max(np.abs(g64))


@pytest.mark.parametrize('regime', ['dense', 'grid'])
def test_fit_matches_f64(interfaces, regime):
    """minimize() in f32 from the [sample] start: valid, the best fit
    within 1e-2 of the errors of the f64 fit's values and fval within the
    ladder. The dense f64 fit recovers the truth (the dataset is the
    model at the defaults) to 1e-15 and takes ~50 value and gradient
    calls, ~25 s here: the dense f32 fit is held to the truth instead.
    chip_smoke.py's f32 phase holds synthetic-full's fits to vega_tpu's
    f32 fits. Measured: dense 8.4e-5 errors from the truth, fval
    2.9e-8; grid 7.5e-5 errors, fval 5.7e-3 from f64's (63.267 on 8 x 8
    nodes)."""
    fits = {}
    for dtype in ((torch.float32,) if regime == 'dense'
                  else (torch.float32, torch.float64)):
        vega = interfaces[regime, dtype]
        vega.minimize()
        fits[dtype] = vega.bestfit
    best = fits[torch.float32]
    want = fits.get(torch.float64)
    values = TRUTH if want is None else want.values
    assert best.fmin.is_valid
    assert max(abs(best.values[n] - values[n]) / best.errors[n]
               for n in NAMES) <= FIT_SIGMA
    assert abs(best.fmin.fval - (0.0 if want is None
                                 else want.fmin.fval)) <= LADDER_ABS


def test_dtype_follows_vega_tpu_x64(tiny, env):
    """VEGA_TPU_X64=0 selects f32 as vega_tpu/__init__.py:22 reads it,
    anything else f64; the argument overrides the variable. An interface
    turns TF32 off, so its f32 products are true f32."""
    assert resolve_dtype() == torch.float64
    for value, want in (('0', torch.float32), ('1', torch.float64),
                        ('', torch.float64)):
        env.setenv('VEGA_TPU_X64', value)
        assert resolve_dtype() == want
    assert resolve_dtype(torch.float32) == torch.float32
    env.setenv('VEGA_TPU_X64', '0')
    assert resolve_dtype(torch.float64) == torch.float64
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert VegaInterface(tiny, device='cpu').dtype == torch.float32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    env.delenv('VEGA_TPU_X64')
    with pytest.raises(TypeError, match='float64 or float32'):
        resolve_dtype(torch.float16)


def test_payload_fingerprint_separates_the_dtypes(interfaces):
    """An f32 payload never serves an f64 interface through the shared
    disk cache: the fingerprint hashes the interface's dtype, as
    vega_tpu's hashes its x64 mode (vega_tpu/gridcollapse.py:346-347)."""
    names = tuple(sorted(NAMES))
    prints = {}
    for dtype in (torch.float32, torch.float64):
        vega = interfaces['grid', dtype]
        spec = vega.get_collapsed(names)['__grid__']
        prints[dtype] = gc.payload_fingerprint(vega, names, spec, 2e-4,
                                               1e-12)
    assert prints[torch.float32] != prints[torch.float64]


def test_penalty_is_inf_as_in_vega_tpu(interfaces):
    """A penalised row (ap = 100 rescales r beyond the knots) is 1e100 in
    f64 and inf in f32, where vega_tpu's jnp.where(bad, 1e100, chi2)
    (vega_tpu/vega_interface.py:529) rounds the penalty to inf."""
    batch = {k: [v[0], 100.0 if k == 'ap' else v[0]]
             for k, v in POINTS.items()}
    got32 = interfaces['dense', torch.float32].chi2_batch(batch)
    got64 = interfaces['dense', torch.float64].chi2_batch(batch)
    assert got64[1] == PENALTY_CHI2 and np.isfinite(float(got32[0]))
    want = jnp.where(jnp.array([False, True]), 1e100,
                     jnp.asarray(got32.numpy()))
    assert want.dtype == jnp.float32 and np.isinf(want[1])
    assert torch.isinf(got32[1]) and got32[1] > 0


# the parameters the model terms below read (a few unused by each case)
TERM_PARAMETERS = ('par_sigma_smooth = 2.4\nper_sigma_smooth = 2.4\n'
                   'sigma_velo_disp_gauss_QSO = 3.1\nbias_gamma = 0.1125\n'
                   'bias_prim = -0.66\nlambda_uv = 300.\nArel1 = -13.5\n'
                   'Arel3 = 1.\n')


@pytest.mark.parametrize('ini, section, text, refused', [
    ('lyaxlya', 'model', 'pk-damping-scale = 10.', False),
    ('lyaxlya', 'model', 'mock-bin-size = 4.', False),
    ('qsoxlya', 'model', 'velocity dispersion = gauss', False),
    ('lyaxlya', 'model', 'UVB-fluctuations = True', False),
    ('lyaxlya', 'model', 'fullshape smoothing = gauss', False),
    ('qsoxlya', 'model', 'relativistic correction = True', False),
    ('lyaxlya', 'model', 'marginalize-all-rmin-cuts = True', True),
    ('main', 'control', 'model_pk = True', True),
    ('lyaxlya', 'model', 'rescale-coords-systematics = True', False),
    ('lyaxlya', 'model', 'fht_extrap = True', False),
    ('main', 'output', 'write_cf = True', True),
], ids=['pk_damping', 'mock_binning', 'gauss_dispersion', 'uv',
        'smoothing', 'relativistic', 'marginalization', 'model_pk',
        'rescale_coords', 'fht_extrap', 'components'])
def test_uncovered_configurations_are_refused(tiny, tmp_path, ini, section,
                                              text, refused):
    """What the f32 mode refused until it carried it builds in f32 and
    gives a finite f32 result within the ladder of the f64 interface's
    on the same files, never an f64 run: the model terms (Pk damping,
    mock binning, the Gaussian velocity dispersion, UV fluctuations,
    full-shape smoothing, the relativistic correction,
    rescale-coords-systematics, fht_extrap) and, `refused` until the
    likelihood options joined the f32 mode, small-scale marginalization
    (all-rmin; the r-min cut at 40, since at size='tiny' no bin lies
    below the default), save-components (the chi^2, and compute_model's
    saved components in float32) and model_pk (its multipoles, within
    MULTIPOLE_RTOL of max|f64|; it has no chi^2). tests/test_torch_f32_
    terms.py and tests/test_torch_f32_options.py hold them against
    vega_tpu; the HCD, NL, old_fftlog, radiation, metals, broadband and
    joint-covariance cases run in tests/test_torch_f32_models.py, the
    sampler and Monte-Carlo cases in tests/test_torch_f32_campaigns.py."""
    src = Path(tiny).parent
    for path in src.iterdir():
        body = path.read_bytes()
        if path.suffix == '.ini':
            body = body.replace(str(src).encode(), str(tmp_path).encode())
        (tmp_path / path.name).write_bytes(body)
    target = tmp_path / f'{ini}.ini'
    lines = target.read_text()
    if text.startswith('velocity dispersion'):
        # the cross's own velocity dispersion line gives way to the case's
        lines = lines.replace('velocity dispersion = lorentz\n', '')
    header = f'[{section}]\n'
    lines = (lines.replace(header, header + text + '\n', 1)
             if header in lines else lines + f'\n{header}{text}\n')
    target.write_text(lines)
    if text.startswith('marginalize-all-rmin-cuts'):
        # all-rmin marginalizes the bins the r-min cut leaves out
        with_rmin_cut(target)
    main = tmp_path / 'main.ini'
    main.write_text(main.read_text().replace(
        '[parameters]\n', '[parameters]\n' + TERM_PARAMETERS, 1))
    vegas = {dtype: VegaInterface(main, device='cpu', dtype=dtype)
             for dtype in (torch.float32, torch.float64)}
    if text.startswith('model_pk'):
        models = {dtype: vega.compute_model(run_init=False)
                  for dtype, vega in vegas.items()}
        for name, got in models[torch.float32].items():
            want = models[torch.float64][name]
            assert got.dtype == np.float32 and np.all(np.isfinite(got))
            assert (np.max(np.abs(got - want)) <= MULTIPOLE_RTOL
                    * np.max(np.abs(want)))
        return
    chi2 = {dtype: vega.chi2_batch(
        {n: POINTS[n] for n in ('bias_LYA', 'beta_LYA')})
        for dtype, vega in vegas.items()}
    assert chi2[torch.float32].dtype == torch.float32
    assert np.all(np.isfinite(chi2[torch.float32].numpy()))
    assert within_ladder(chi2[torch.float32].numpy(),
                         chi2[torch.float64].numpy())
    if refused and text.startswith('write_cf'):
        vega = vegas[torch.float32]
        vega.compute_model(run_init=False)
        for model in vega.models.values():
            xi = model.xi_distorted['smooth']['core']
            assert xi.dtype == np.float32 and np.all(np.isfinite(xi))
