"""The spline + Legendre combine of the PyTorch port (the plain version
its CUDA kernel is held against on the card) against the JAX package:
vega_tpu.ops.spline.spline_eval + the Legendre sum in f64, and the Pallas
kernel in interpret mode (f32). Also the wrapper's checks and routing on
tensors that are not on a GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vega_tpu.ops.pallas_spline import spline_legendre_combine as pallas_combine
from vega_tpu.ops.spline import notaknot_second_derivative_matrix
from vega_tpu.ops.spline import spline_eval as jax_spline_eval
from vega_tpu_torch.ops.spline import spline_eval
from vega_tpu_torch.ops.spline_combine import (
    LAUNCHES, KnotGrid, spline_legendre_combine,
    spline_legendre_combine_reference)

F64_TOL = 1e-13     # both sides f64, same arithmetic up to sum order
F32_TOL = 2e-4      # the Pallas kernel casts everything to f32


def tables(rng, n_b, n_ell, knots):
    """Knot values and their not-a-knot second derivatives, (B, L, N)."""
    y = rng.normal(size=(n_b, n_ell, len(knots)))
    s_mat = notaknot_second_derivative_matrix(knots)
    return y, np.einsum('ij,blj->bli', s_mat, y)


def jax_combine(knots, y, m, x, leg):
    """JAX reference: spline_eval at x, Legendre-weighted sum over ell
    (jitted: one compile instead of one per eager op)."""
    @jax.jit
    def combine(y, m, x, leg):
        vals, _ = jax_spline_eval(knots, y, m, x[:, None, :])  # (B, L, M)
        return jnp.sum(vals * leg, axis=1)
    return np.asarray(combine(y, m, x, leg))


def port_combine(knots, y, m, x, leg, shared):
    """The port's wrapper on CPU tensors; shared rows as row stride 0."""
    n_b, n_ell, _ = y.shape
    n_q = x.shape[-1]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    if shared:
        xt, lt = t(x[0]).expand(n_b, n_q), t(leg[0]).expand(n_b, n_ell, n_q)
    else:
        xt, lt = t(x), t(leg)
    return spline_legendre_combine(KnotGrid.build(knots, 'cpu'), t(y), t(m),
                                   xt, lt).numpy()


@pytest.mark.parametrize('n_b,n_q,shared', [
    (1, 1, False), (1, 777, False), (3, 2500, False), (4, 1000, True),
    (2, 1031, True)])
def test_plain_combine_matches_jax_f64(n_b, n_q, shared):
    rng = np.random.default_rng(n_b * 1000 + n_q)
    knots = np.log(np.logspace(-3, 4, 200))       # uniform in log r
    y, m = tables(rng, n_b, 4, knots)
    # about 10% of the queries outside the knot range (clamped)
    span = knots[-1] - knots[0]
    x = rng.uniform(knots[0] - 0.05 * span, knots[-1] + 0.05 * span,
                    (n_b, n_q))
    leg = rng.uniform(-1, 1, (n_b, 4, n_q))
    x[:, 0] = knots[0]          # the ends exactly
    x[:, -1] = knots[-1]
    if shared:
        x[:] = x[0]
        leg[:] = leg[0]
    want = jax_combine(knots, y, m, x, leg)
    got = port_combine(knots, y, m, x, leg, shared)
    assert got.shape == (n_b, n_q)
    assert np.max(np.abs(got - want)) <= F64_TOL * np.max(np.abs(want))


def test_queries_on_knots_pick_the_guarded_interval():
    """Queries exactly on the knots and one ulp away: the round-off guard
    of vega_tpu/ops/spline.py:88-92 decides the interval."""
    rng = np.random.default_rng(7)
    knots = np.log(np.logspace(-3, 4, 814))
    y, m = tables(rng, 1, 2, knots)
    x = np.concatenate([knots, np.nextafter(knots, -np.inf),
                        np.nextafter(knots, np.inf)])[None]
    leg = rng.uniform(-1, 1, (1, 2, x.shape[1]))
    want = jax_combine(knots, y, m, x, leg)
    got = port_combine(knots, y, m, x, leg, shared=False)
    assert np.max(np.abs(got - want)) <= F64_TOL * np.max(np.abs(want))


def test_plain_combine_matches_pallas_kernel_f32():
    """Held against the Pallas kernel as tests/test_pallas_spline.py runs
    it (interpret mode): queries inside the knot range."""
    rng = np.random.default_rng(0)
    knots = np.linspace(-3.0, 8.0, 256)
    y, m = tables(rng, 1, 4, knots)
    x = rng.uniform(-3.0, 8.0, (1, 1000))
    leg = rng.normal(size=(1, 4, 1000))
    got = port_combine(knots, y, m, x, leg, shared=False)
    want = np.asarray(pallas_combine(knots, y[0], m[0], x[0], leg[0],
                                     interpret=True))
    np.testing.assert_allclose(got[0], want, rtol=F32_TOL, atol=F32_TOL)


def test_spline_eval_matches_jax():
    rng = np.random.default_rng(3)
    knots = np.linspace(0.0, 5.0, 64)
    y = rng.normal(size=(3, 64))
    m = y @ notaknot_second_derivative_matrix(knots).T
    xq = rng.uniform(knots[0] - 0.3, knots[-1] + 0.3, (3, 500))
    vals_j, oob_j = jax.jit(lambda y, m, xq: jax_spline_eval(
        knots, y, m, xq))(y, m, xq)
    vals, oob = spline_eval(knots, torch.as_tensor(y), torch.as_tensor(m),
                            torch.as_tensor(xq))
    np.testing.assert_array_equal(oob.numpy(), np.asarray(oob_j))
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j),
                               rtol=F64_TOL, atol=F64_TOL)


def test_spline_eval_rejects_non_uniform_knots():
    """The transform's knots are uniform in log r; other grids (which
    vega_tpu's spline_eval takes by binary search) raise."""
    knots = np.cumsum(np.random.default_rng(4).uniform(0.05, 0.15, 64))
    y = torch.zeros(1, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match='uniform'):
        spline_eval(knots, y, y, torch.zeros(1, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match='uniform'):
        KnotGrid.build(knots, 'cpu')


def _inputs(n_b=2, n_ell=4, n_knots=16, n_q=10, dtype=torch.float64):
    grid = KnotGrid.build(np.linspace(0, 1, n_knots), 'cpu')
    y = torch.zeros(n_b, n_ell, n_knots, dtype=dtype)
    return (grid, y, y.clone(), torch.zeros(n_b, n_q, dtype=dtype),
            torch.zeros(n_b, n_ell, n_q, dtype=dtype))


@pytest.mark.parametrize('case,error', [
    ('f32', TypeError), ('bad_y', ValueError), ('bad_knots', ValueError),
    ('bad_x', ValueError), ('bad_leg', ValueError),
    ('strided_x', ValueError), ('strided_leg', ValueError),
    ('meta', ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    grid, y, m, x, leg = _inputs()
    if case == 'f32':
        x = x.float()
    elif case == 'bad_y':
        y = y[:, :, :8]
    elif case == 'bad_knots':
        y, m = y[:, :, :8].contiguous(), m[:, :, :8].contiguous()
    elif case == 'bad_x':
        x = x[:1]
    elif case == 'bad_leg':
        leg = leg[:, :3]
    elif case == 'strided_x':
        x = torch.zeros(2, 20, dtype=torch.float64)[:, ::2]
    elif case == 'strided_leg':
        leg = torch.zeros(2, 10, 4, dtype=torch.float64).transpose(1, 2)
    elif case == 'meta':
        grid = KnotGrid.build(grid.values, 'meta')
        y, m, x, leg = (t.to('meta') for t in (y, m, x, leg))
    with pytest.raises(error):
        spline_legendre_combine(grid, y, m, x, leg)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    knots = np.linspace(0.0, 1.0, 32)
    y, m = (torch.as_tensor(a) for a in tables(rng, 2, 3, knots))
    x = torch.as_tensor(rng.uniform(0, 1, (2, 50)))
    leg = torch.as_tensor(rng.normal(size=(2, 3, 50)))
    grid = KnotGrid.build(knots, 'cpu')
    before = sum(LAUNCHES.values())
    out = spline_legendre_combine(grid, y, m, x, leg)
    assert torch.equal(out, spline_legendre_combine_reference(
        grid, y, m, x, leg))
    assert sum(LAUNCHES.values()) == before   # no kernel here
