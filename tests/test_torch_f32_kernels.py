"""The f32 spline + Legendre combine of the PyTorch port against the JAX
package's Pallas kernels, which are f32 only (vega_tpu/ops/pallas_spline.py),
run in interpret mode on the CPU as tests/test_pallas_spline.py runs them:

- F_0, the port's plain version in f32 (what the f32 CUDA kernel is held
  to on the card), against `spline_legendre_combine` and
  `spline_legendre_combine_batched`, at queries inside knot intervals
  and exactly on knots, with M not a multiple of the Pallas tile (1024:
  M = 1500 and 1100, two tiles each);
- F_d, P_d and Ft_d through the autograd Functions against jax.grad of
  `make_vmappable_combine(..., interpret=True)` (its custom_vjp: the XLA
  VJP of `spline_eval` in f32), and the second derivative to x against
  jax.grad of jax.grad of that f32 XLA formulation;
- the f32 wrappers' checks and cost model.

The knot grid is the transform's: N = 814 knots uniform in log r.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vega_tpu.ops.pallas_spline import (make_vmappable_combine,
                                        spline_legendre_combine as pallas_f0,
                                        spline_legendre_combine_batched)
from vega_tpu.ops.spline import spline_eval
from vega_tpu_torch.ops import spline_combine as sc
from vega_tpu_torch.ops.spline import notaknot_second_derivative_matrix

# max|port f32 - Pallas f32| <= TOL max|Pallas|: both are f32, and near
# a knot the two may pick adjacent intervals (Pallas: x0 + j step; the
# port: the neighbouring knots), the same cubic to f32 round-off.
# Measured: F_0 8.1e-7 / 1.2e-6 (inside / on knots), batched 1.1e-6 /
# 1.1e-6, grouped 1.1e-6 / 1.0e-6; gradients 1.1e-6 (y), 3.9e-7 (m),
# 3.5e-7 (leg); the second derivative to x 6.7e-7.
TOL = 1e-5
# the gradient to x: (y_hi - y_lo) / h over a step of 0.011, where the
# two packages round the cancelling difference in other orders (jax.grad
# of y_lo t_hi + y_hi t_lo against the weights -1/h, 1/h): f32 round-off
# ~100x amplified. Measured 5.3e-6 at 1,200 queries, 1.2e-5 at these 700.
X_GRAD_TOL = 3e-5
N_KNOTS, N_ELL = 814, 4
KNOTS = np.linspace(np.log(0.1), np.log(1500.0), N_KNOTS)


def tables(rng, n_b):
    """(y, m) f32 knot tables of smooth multipoles, (n_b, L, N)."""
    r = np.exp(KNOTS)
    base = np.stack([np.sin(r / (20.0 + 7 * ell)) / (1 + r / 50.0)
                     for ell in range(N_ELL)])
    y = base[None] * (1 + 0.1 * rng.normal(size=(n_b, N_ELL, 1)))
    m = y @ notaknot_second_derivative_matrix(KNOTS).T
    return y.astype(np.float32), m.astype(np.float32)


def queries(rng, n_q, on_knots):
    """n_q log r queries inside the knot range: uniform, or every other
    one exactly on a knot (its f32 value, both ends included)."""
    x = rng.uniform(KNOTS[0], KNOTS[-1], n_q)
    if on_knots:
        x[::2] = KNOTS[rng.integers(0, N_KNOTS, x[::2].shape)]
        x[:2] = KNOTS[0], KNOTS[-1]
    return x.astype(np.float32)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope='module')
def grid():
    return sc.KnotGrid.build(KNOTS, 'cpu', torch.float32)


@pytest.mark.parametrize('on_knots', [False, True])
def test_forward_matches_pallas(grid, on_knots):
    rng = np.random.default_rng(0)
    n_q = 1500
    y, m = tables(rng, 1)
    x = queries(rng, n_q, on_knots)
    leg = rng.uniform(-1, 1, (N_ELL, n_q)).astype(np.float32)
    want = np.asarray(pallas_f0(KNOTS, y[0], m[0], x, leg, interpret=True))
    got = sc.combine_forward(grid, torch.from_numpy(y), torch.from_numpy(m),
                             torch.from_numpy(x)[None],
                             torch.from_numpy(leg)[None])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert rel(got[0].numpy(), want) <= TOL


@pytest.mark.parametrize('on_knots', [False, True])
def test_batched_forward_matches_pallas(grid, on_knots):
    """Rows with their own coordinates, and rows in groups sharing one
    coordinate row (the sweep's layout), against the batched kernel."""
    rng = np.random.default_rng(1)
    n_b, n_q = 4, 1100
    y, m = tables(rng, n_b)
    x = np.stack([queries(rng, n_q, on_knots) for _ in range(n_b)])
    leg = rng.uniform(-1, 1, (n_b, N_ELL, n_q)).astype(np.float32)
    want = np.asarray(spline_legendre_combine_batched(
        KNOTS, y, m, x, leg, interpret=True))
    t = torch.from_numpy
    got = sc.combine_forward(grid, t(y), t(m), t(x), t(leg))
    assert got.dtype == torch.float32 and got.shape == (n_b, n_q)
    assert rel(got.numpy(), want) <= TOL
    # two groups of two rows, each group reading one coordinate row
    shared = np.repeat(x[::2], 2, axis=0), np.repeat(leg[::2], 2, axis=0)
    want = np.asarray(spline_legendre_combine_batched(
        KNOTS, y, m, *shared, interpret=True))
    got = sc.combine_forward(grid, t(y), t(m), t(x[::2].copy()),
                             t(leg[::2].copy()), group=2)
    assert rel(got.numpy(), want) <= TOL


@pytest.fixture(scope='module')
def vjp_case():
    """One row's f32 inputs, with every other query on a knot, and the
    Pallas combine's cotangent weights."""
    rng = np.random.default_rng(2)
    n_q = 700
    y, m = tables(rng, 1)
    x = queries(rng, n_q, True)
    leg = rng.uniform(-1, 1, (N_ELL, n_q)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n_q).astype(np.float32)
    return y[0], m[0], x, leg, w


def test_gradients_match_pallas_vjp(grid, vjp_case):
    """F_d / P_d / Ft_d (d = 0, 1) of the backward against jax.grad
    through make_vmappable_combine's custom_vjp."""
    y, m, x, leg, w = vjp_case
    combine = make_vmappable_combine(KNOTS, interpret=True)
    want = jax.grad(lambda *a: jnp.sum(w * combine(*a) ** 2),
                    argnums=(0, 1, 2, 3))(y, m, x, leg)
    leaves = [torch.tensor(a[None], requires_grad=True)
              for a in (y, m, x, leg)]
    out = sc.spline_legendre_combine(grid, *leaves)
    got = torch.autograd.grad(torch.sum(torch.from_numpy(w) * out ** 2),
                              leaves)
    for g, g_want, tol in zip(got, want, (TOL, TOL, X_GRAD_TOL, TOL)):
        assert g.dtype == torch.float32
        assert rel(g[0].numpy(), g_want) <= tol


def test_second_derivatives_match_the_f32_xla_vjp(grid, vjp_case):
    """The gradient to x differentiated again (F_2 through the Functions'
    double backward) against jax.grad of jax.grad of the f32 XLA
    formulation that make_vmappable_combine's backward differentiates
    (`spline_eval` on f32 knots, pallas_spline.py:270-276): jax cannot
    take a second derivative through the Pallas forward itself."""
    y, m, x, leg, w = vjp_case
    knots32 = np.asarray(KNOTS, np.float32)

    def jax_loss(xq):
        vals, _ = spline_eval(knots32, y[:, None, :], m[:, None, :],
                              xq[None, :])
        return jnp.sum(w * jnp.sum(vals[:, 0, :] * leg, axis=0))

    want = np.asarray(jax.grad(
        lambda xq: jnp.sum(jax.grad(jax_loss)(xq) ** 2))(x))
    assert want.dtype == np.float32
    xt = torch.tensor(x[None], requires_grad=True)
    t = torch.from_numpy
    out = sc.spline_legendre_combine(grid, t(y[None]), t(m[None]), xt,
                                     t(leg[None]))
    (gx,) = torch.autograd.grad(torch.sum(t(w) * out), xt,
                                create_graph=True)
    (got,) = torch.autograd.grad(torch.sum(gx ** 2), xt)
    assert got.dtype == torch.float32
    assert rel(got[0].numpy(), want) <= TOL


def test_f32_wrappers_check_the_dtype(grid):
    """Every tensor of a call has the knot grid's dtype: an f64 tensor
    with an f32 grid is refused, never run in f64."""
    rng = np.random.default_rng(3)
    y, m = (torch.from_numpy(a) for a in tables(rng, 1))
    x = torch.from_numpy(queries(rng, 50, False))[None]
    leg = torch.ones((1, N_ELL, 50), dtype=torch.float32)
    with pytest.raises(TypeError, match='float32'):
        sc.combine_forward(grid, y.double(), m, x, leg)
    with pytest.raises(TypeError, match='float32'):
        sc.combine_transpose(grid, torch.ones((1, 50)), x, leg.double())
    with pytest.raises(TypeError, match='float64 or float32'):
        sc.KnotGrid.build(KNOTS, 'cpu', torch.float16)
    out = sc.combine_points(grid, y, m, x, order=2)
    assert out.dtype == torch.float32 and out.shape == (1, N_ELL, 50)


def test_f32_cost_model():
    """An f32 launch moves half the bytes of the same f64 launch, and its
    flops go at the card's f32 rate; an f32 layout ends in 'f32'."""
    layout = (1024, N_ELL, N_KNOTS, 1, 1024, 5000, False, False)
    for primitive in ('F', 'P', 'Ft'):
        f64 = sc.launch_bytes(primitive, 0, *layout)
        assert sc.launch_bytes(primitive, 0, *layout, 'f32') * 2 == f64
        ms64, by64 = sc.launch_bound(primitive, 0, *layout)
        ms32, by32 = sc.launch_bound(primitive, 0, *layout, 'f32')
        assert by64 == by32 == 'bytes' and ms32 == pytest.approx(ms64 / 2)
    assert (sc.FLOPS_PER_S, sc.WORD_BYTES) == (
        {'f64': 34e12, 'f32': 67e12}, {'f64': 8, 'f32': 4})
