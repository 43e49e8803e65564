"""Exact derivatives and the fit of the PyTorch port against the JAX
package (vega_tpu), on the CPU.

1. The differentiable spline + Legendre combine (the autograd Functions
   of vega_tpu_torch.ops.spline_combine, with their plain primitives on
   the CPU): gradients and Hessian-vector products against torch autograd
   through the plain `spline_eval`, against jax.grad / jax.hessian of
   vega_tpu.ops.spline.spline_eval in f64, and against the f32
   `make_vmappable_combine` (Pallas forward in interpret mode, XLA VJP).
   The kernel route, with stub kernels, shows that a tensor that requires
   grad either goes through the Functions or raises.
2. chi2_value_and_gradient and chi2_hessian of VegaInterface against
   vega_tpu's at 4 points on the tiny synthetic auto+cross dataset with
   (ap, at, bias_LYA, beta_LYA) sampled, 8 x 8 grid nodes and the exact
   f64 payload contractions (ds-matmul = False): the grid path on
   vega_tpu's own payload, on the port's payload, the nuisance-only
   collapse and the dense path (VEGA_TPU_FACTORED=0). One point puts ap
   exactly on the node domain's end.
3. minimize() against vega_tpu's from the same start, on the grid and the
   dense path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vega_tpu.gridcollapse as jgc
from vega_tpu.ops.pallas_spline import make_vmappable_combine
from vega_tpu.ops.spline import notaknot_second_derivative_matrix
from vega_tpu.ops.spline import spline_eval as jax_spline_eval
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.ops import spline_combine as sc
from vega_tpu_torch.ops.spline_combine import (
    KnotGrid, spline_legendre_combine, spline_legendre_combine_reference)
from vega_tpu_torch.vega_interface import VegaInterface

GRAD_RTOL = 1e-12       # Function vs autograd / jax.grad, f64
HVP_RTOL = 1e-10        # Hessian-vector products, f64
# vs the f32 Pallas combine: its own test's bound, here relative to the
# largest entry of each gradient (the port is f64, the Pallas path f32)
F32_TOL = 1e-4
# chi^2, gradient and Hessian against vega_tpu, relative to the largest
# entry of each (f64 both sides; the sums are ordered differently)
PAYLOAD_RTOL = 1e-10    # grid path on vega_tpu's own payload
NUISANCE_RTOL = 1e-10   # nuisance-only collapse
DENSE_RTOL = 1e-9       # dense path (model, Hankel transform, combine)
# the grid path on the port's own payload, which is held to vega_tpu's
# only within the 2e-4 chi^2 mode budget (~1e-6 of the chi^2 here); the
# same node tensors (1e-11) give the same retained modes on this dataset,
# and the worst of the 4 points measured 1.1e-13 (value), 3.4e-14
# (gradient) and 1.4e-15 (Hessian) relative
OWN_PAYLOAD_RTOL = 1e-8

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
POINTS = [
    {'ap': 1.03, 'at': 0.97, 'bias_LYA': -0.12, 'beta_LYA': 1.6},
    {'ap': 0.9, 'at': 1.1, 'bias_LYA': -0.11, 'beta_LYA': 1.75},
    {'ap': 1.18, 'at': 0.85, 'bias_LYA': -0.125, 'beta_LYA': 1.52},
    # ap on the node domain's end (limits 0.5..1.5, pad 0.25): the
    # clip's subgradient there is 1/2 in vega_tpu
    {'ap': 1.25, 'at': 1.0, 'bias_LYA': -0.118, 'beta_LYA': 1.66},
]


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ----------------------------------------------------------------------
# 1. The combine's autograd Functions
# ----------------------------------------------------------------------
N_KNOTS, N_ELL, N_B, N_Q = 24, 3, 3, 40


def combine_inputs(seed, shared):
    """Random tables; queries inside, outside, on both ends and exactly
    on knots; per-row coordinates, or one row shared (row stride 0)."""
    rng = np.random.default_rng(seed)
    knots = np.log(np.logspace(-1.0, 2.5, N_KNOTS))
    y = rng.normal(size=(N_B, N_ELL, N_KNOTS))
    m = np.einsum('ij,blj->bli', notaknot_second_derivative_matrix(knots), y)
    span = knots[-1] - knots[0]
    rows = 1 if shared else N_B
    x = rng.uniform(knots[0] - 0.05 * span, knots[-1] + 0.05 * span,
                    (rows, N_Q))
    x[:, 0], x[:, 1] = knots[0], knots[-1]
    x[:, 2:6] = knots[[3, 7, 12, 20]]
    leg = rng.uniform(-1, 1, (rows, N_ELL, N_Q))
    w = rng.normal(size=(N_B, N_Q))
    return knots, y, m, x, leg, w


def torch_loss(knots, inputs, w, shared, fn):
    """sum(w * combine) with the tensors of `inputs` as leaves (x and leg
    expanded to B rows with row stride 0 when shared)."""
    y, m, x, leg = inputs
    if shared:
        x, leg = x[0].expand(N_B, N_Q), leg[0].expand(N_B, N_ELL, N_Q)
    grid = KnotGrid.build(knots, 'cpu')
    return torch.sum(torch.as_tensor(w) * fn(grid, y, m, x, leg))


def torch_derivatives(knots, arrays, w, shared, fn, tangents):
    """(gradients, Hessian-vector products) of the loss in all inputs."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = torch_loss(knots, leaves, w, shared, fn)
    grads = torch.autograd.grad(loss, leaves, create_graph=True)
    dot = sum(torch.sum(g * torch.as_tensor(t))
              for g, t in zip(grads, tangents))
    hvps = torch.autograd.grad(dot, leaves)
    return ([g.detach().numpy() for g in grads],
            [h.numpy() for h in hvps])


def jax_derivatives(knots, arrays, w, shared, tangents):
    def loss(y, m, x, leg):
        if shared:
            x, leg = x[0], leg[0]
        vals, _ = jax_spline_eval(knots, y, m, x[..., None, :])
        return jnp.sum(w * jnp.sum(vals * leg, axis=-2))

    grad = jax.grad(loss, argnums=(0, 1, 2, 3))
    grads = jax.jit(grad)(*arrays)
    _, hvps = jax.jit(lambda a, t: jax.jvp(grad, a, t))(tuple(arrays),
                                                        tuple(tangents))
    return ([np.asarray(g) for g in grads], [np.asarray(h) for h in hvps])


def function_combine(grid, y, m, x, leg):
    return spline_legendre_combine(grid, y, m, x, leg)


def plain_combine(grid, y, m, x, leg):
    return spline_legendre_combine_reference(grid, y, m, x, leg)


@pytest.mark.parametrize('shared', [False, True], ids=['per_row', 'stride0'])
def test_combine_derivatives_match_autograd_and_jax(shared):
    knots, y, m, x, leg, w = combine_inputs(11 + shared, shared)
    arrays = (y, m, x, leg)
    rng = np.random.default_rng(3)
    tangents = [rng.normal(size=a.shape) for a in arrays]
    got = torch_derivatives(knots, arrays, w, shared, function_combine,
                            tangents)
    plain = torch_derivatives(knots, arrays, w, shared, plain_combine,
                              tangents)
    jax_ = jax_derivatives(knots, arrays, w, shared, tangents)
    for want in (plain, jax_):
        for name, g, h, g_want, h_want in zip('ymxl', *got, *want):
            assert max_rel(g, g_want) <= GRAD_RTOL, name
            assert max_rel(h, h_want) <= HVP_RTOL, name
    # the clamp's subgradient: queries outside get no x-gradient
    if not shared:
        outside = (x < knots[0]) | (x > knots[-1])
        assert outside.any() and np.all(got[0][2][outside] == 0.0)


def test_combine_third_order_matches_jax():
    """A third derivative in x goes through F_3 (S^(3) piecewise
    constant) and the zero F_4."""
    knots, y, m, x, leg, w = combine_inputs(5, False)
    grid = KnotGrid.build(knots, 'cpu')
    xt = torch.tensor(x, requires_grad=True)

    def d3(fn):
        out = torch.sum(torch.as_tensor(w) * fn(
            grid, torch.as_tensor(y), torch.as_tensor(m), xt,
            torch.as_tensor(leg)))
        g = torch.autograd.grad(out, xt, create_graph=True)[0]
        g2 = torch.autograd.grad(g.sum(), xt, create_graph=True)[0]
        return torch.autograd.grad(g2.sum(), xt)[0].numpy()

    def jax_loss(x):
        vals, _ = jax_spline_eval(knots, y, m, x[:, None, :])
        return jnp.sum(w * jnp.sum(vals * leg, axis=1))

    g1 = jax.grad(jax_loss)
    g2 = jax.grad(lambda x: jnp.sum(g1(x)))
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(g2(x))))(x))
    assert max_rel(d3(function_combine), want) <= GRAD_RTOL


def test_combine_gradients_match_pallas_f32():
    """Against the f32 `make_vmappable_combine` (Pallas forward in
    interpret mode, XLA VJP backward), within its own test's tolerance
    (tests/test_pallas_spline.py::test_combine_gradients_match_xla):
    queries inside knot intervals, where f32 and f64 pick the same
    interval."""
    rng = np.random.default_rng(0)
    n_knots, n_q, n_ell = 64, 100, 4
    knots = np.linspace(0.0, 1.0, n_knots)
    y = rng.normal(size=(n_ell, n_knots)).astype(np.float32)
    m = rng.normal(size=(n_ell, n_knots)).astype(np.float32)
    step = 1.0 / (n_knots - 1)
    cells = rng.integers(1, n_knots - 2, size=n_q)
    xq = ((cells + rng.uniform(0.25, 0.75, size=n_q)) * step).astype(
        np.float32)
    leg = rng.normal(size=(n_ell, n_q)).astype(np.float32)
    combine = make_vmappable_combine(knots, interpret=True)
    want = jax.grad(lambda *a: jnp.sum(combine(*a) ** 2),
                    argnums=(0, 1, 2, 3))(y, m, xq, leg)
    leaves = [torch.tensor(a[None].astype(np.float64), requires_grad=True)
              for a in (y, m, xq, leg)]
    out = spline_legendre_combine(KnotGrid.build(knots, 'cpu'), *leaves)
    got = torch.autograd.grad(torch.sum(out ** 2), leaves)
    for g, g_want in zip(got, want):
        assert max_rel(g[0].numpy(), g_want) <= F32_TOL


def test_grouped_combine_has_no_gradient():
    knots, y, m, x, leg, _ = combine_inputs(2, False)
    grid = KnotGrid.build(knots, 'cpu')
    y_t = torch.tensor(y, requires_grad=True)
    x1, leg1 = torch.as_tensor(x[:1]), torch.as_tensor(leg[:1])
    with pytest.raises(ValueError, match='row groups'):
        spline_legendre_combine(grid, y_t, torch.as_tensor(m), x1, leg1,
                                group=N_B)
    with torch.no_grad():       # the sweep's way: no gradient asked
        out = spline_legendre_combine(grid, y_t, torch.as_tensor(m), x1,
                                      leg1, group=N_B)
    assert out.shape == (N_B, N_Q) and not out.requires_grad


def check_plan(plan, n_b, n_q):
    """The wrappers hand each kernel the launch plan of its (B, M)."""
    assert plan == sc.launch_plan(n_b, n_q)


@pytest.fixture
def stub_kernels(monkeypatch):
    """The kernel route on CPU tensors, with stub kernels that write the
    plain versions into the wrappers' outputs: the wrappers launch (and
    count) as they do on a card."""
    monkeypatch.setattr(sc, '_kernel_route',
                        lambda device, use_kernel: use_kernel)

    def forward(grid, y, m, x, leg, out, order, group, x_rs, leg_rs,
                plan):
        check_plan(plan, y.shape[0], x.shape[1])
        out.copy_(sc.spline_legendre_combine_reference(grid, y, m, x, leg,
                                                       group, order))

    def points(grid, y, m, x, out, order, group, x_rs, plan):
        check_plan(plan, y.shape[0], x.shape[1])
        out.copy_(sc.spline_legendre_points_reference(grid, y, m, x, group,
                                                      order))

    def transpose(grid, g, x, leg, out_y, out_m, scratch, order, x_rs,
                  leg_rs, plan):
        check_plan(plan, *g.shape)
        tiles = plan[0]
        assert (scratch is None) == (tiles == 1)
        assert scratch is None or scratch.shape == (g.shape[0], tiles, 2,
                                                    *out_y.shape[1:])
        for out, ref in zip((out_y, out_m),
                            sc.spline_legendre_transpose_reference(
                                grid, g, x, leg, order)):
            out.copy_(ref)

    monkeypatch.setattr(sc, '_forward_kernel', forward)
    monkeypatch.setattr(sc, '_points_kernel', points)
    monkeypatch.setattr(sc, '_transpose_kernel', transpose)
    sc.LAUNCHES.clear()
    yield sc.LAUNCHES
    sc.LAUNCHES.clear()


def test_kernel_route_goes_through_the_functions(stub_kernels):
    """With the kernel route taken, a combine whose inputs require grad
    is differentiated twice through the kernels (F_0..F_2, P_0..P_1,
    Ft_0..Ft_1 launched) and agrees with the plain route; the wrappers
    refuse a tensor that requires grad under grad mode."""
    knots, y, m, x, leg, w = combine_inputs(7, False)
    arrays = (y, m, x, leg)
    tangents = [np.random.default_rng(1).normal(size=a.shape)
                for a in arrays]
    with sc.recorded_launches() as layouts:
        got = torch_derivatives(knots, arrays, w, False, function_combine,
                                tangents)
    want = torch_derivatives(
        knots, arrays, w, False,
        lambda *a: spline_legendre_combine(*a, use_kernel=False), tangents)
    for g, h, g_want, h_want in zip(*got, *want):
        assert max_rel(g, g_want) <= 1e-15
        assert max_rel(h, h_want) <= 1e-15
    launched = {key for key, n in stub_kernels.items() if n}
    assert {('F', 0), ('F', 1), ('F', 2), ('P', 0), ('P', 1), ('Ft', 0),
            ('Ft', 1)} <= launched
    assert {key[:2] for key in layouts} == launched
    assert all(key[2:4] == (N_B, N_ELL) for key in layouts)

    grid = KnotGrid.build(knots, 'cpu')
    t = [torch.tensor(a, requires_grad=True) for a in arrays]
    with pytest.raises(RuntimeError, match='cut off from autograd'):
        sc.combine_forward(grid, *t)
    with pytest.raises(RuntimeError, match='cut off from autograd'):
        sc.combine_points(grid, *t[:3])
    with pytest.raises(RuntimeError, match='cut off from autograd'):
        sc.combine_transpose(grid, torch.ones(N_B, N_Q, requires_grad=True,
                                              dtype=torch.float64),
                             *t[2:])
    with torch.no_grad():
        assert not sc.combine_forward(grid, *t).requires_grad


def test_transpose_is_the_adjoint():
    """<Ft_d(g, x, leg), (U, V)> = <g, F_d(U, V, x, leg)> for d = 0..3."""
    knots, y, m, x, leg, w = combine_inputs(9, False)
    grid = KnotGrid.build(knots, 'cpu')
    tens = [torch.as_tensor(a) for a in (y, m, x, leg, w)]
    for order in range(4):
        ybar, mbar = sc.combine_transpose(grid, tens[4], tens[2], tens[3],
                                          order=order)
        lhs = float(torch.sum(ybar * tens[0]) + torch.sum(mbar * tens[1]))
        rhs = float(torch.sum(tens[4] * sc.combine_forward(
            grid, tens[0], tens[1], tens[2], tens[3], order=order)))
        assert lhs == pytest.approx(rhs, rel=1e-12)
        points = sc.combine_points(grid, tens[0], tens[1], tens[2],
                                   order=order)
        assert torch.allclose(torch.sum(points * tens[3], dim=1),
                              sc.combine_forward(grid, tens[0], tens[1],
                                                 tens[2], tens[3],
                                                 order=order),
                              rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError, match='order'):
        sc.combine_forward(grid, *tens[:4], order=4)


# ----------------------------------------------------------------------
# 2. chi^2 derivatives of VegaInterface against vega_tpu
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """main.ini of the tiny dataset sampling (ap, at, bias_LYA, beta_LYA),
    and vega_tpu's interface (its grid payload built), with the exact f64
    payload contractions and no payload disk cache for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        tmp = tmp_path_factory.mktemp('fit')
        main = jax_make_dataset(
            tmp, cross=True, size='tiny', sample=SAMPLE,
            extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n'
                          'ds-matmul = False')
        jax_vega = JaxInterface(main)
        jgc.save_payload(tmp / 'payload.npz', jax_vega.get_collapsed(NAMES))
        yield {'main': main, 'jax': jax_vega, 'payload': tmp / 'payload.npz'}


@pytest.fixture(scope='module')
def ports(setup):
    """The port on its own payload, on vega_tpu's payload, and on the
    dense path (VEGA_TPU_FACTORED=0, read at construction)."""
    own = VegaInterface(setup['main'], device='cpu')
    on_jax = VegaInterface(setup['main'], device='cpu')
    on_jax.use_grid_payload(NAMES, gc.load_payload(setup['payload']))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        dense = VegaInterface(setup['main'], device='cpu')
    return {'grid_own': own, 'grid_payload': on_jax, 'nuisance': own,
            'dense': dense}


TOLERANCES = {'grid_payload': PAYLOAD_RTOL, 'grid_own': OWN_PAYLOAD_RTOL,
              'nuisance': NUISANCE_RTOL, 'dense': DENSE_RTOL}


def point_for(regime, index):
    point = POINTS[index]
    if regime == 'nuisance':
        return {k: point[k] for k in ('bias_LYA', 'beta_LYA')}
    return dict(point)


@pytest.mark.parametrize('index', range(len(POINTS)))
@pytest.mark.parametrize('regime', list(TOLERANCES))
def test_value_gradient_hessian_match_jax(setup, ports, monkeypatch, regime,
                                          index):
    port, jax_vega = ports[regime], setup['jax']
    if regime == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')   # vega_tpu: at trace
        assert port.get_collapsed(NAMES) == {}
    point = point_for(regime, index)
    names = list(point)
    expected = {'nuisance': {'lyaxlya', 'qsoxlya'}}.get(
        regime, {'__grid__', 'lyaxlya', 'qsoxlya'} if 'grid' in regime
        else set())
    assert set(port.get_collapsed(names)) == expected
    value, grad = port.chi2_value_and_gradient(point)
    hess = port.chi2_hessian(point, names)
    value_j, grad_j = jax_vega.chi2_value_and_gradient(point)
    hess_j = jax_vega.chi2_hessian(point, names)
    tol = TOLERANCES[regime]
    assert set(grad) == set(point)
    assert max_rel(value, value_j) <= tol
    assert max_rel([grad[n] for n in names],
                   [grad_j[n] for n in names]) <= tol
    h = [[hess[a][b] for b in names] for a in names]
    h_j = [[hess_j[a][b] for b in names] for a in names]
    assert max_rel(h, h_j) <= tol
    assert port.chi2_gradient(point) == grad
    if index == 3 and 'grid' in regime:
        # on the domain's end: the wall's curvature and the clipped
        # Chebyshev argument take the 1/2 subgradient (vega_tpu's); with
        # torch.clamp's 1 the ap-ap entry would be off by ~1.5e8
        assert abs(hess['ap']['ap'] - hess_j['ap']['ap']) <= tol * np.max(
            np.abs(h_j))


def test_grid_names_alone_differentiate_the_payload(setup, ports):
    """Sampling only (ap, at) (ROADMAP section 3: vega_tpu serves the chi^2
    at the grid reference then, so its gradient and Hessian are 0): the
    port differentiates the payload, and agrees with vega_tpu's
    derivatives of the 4-name set at the nuisance defaults to 1e-6
    relative (two payloads, each within the mode budget; measured 2.1e-13
    in the value, 1.4e-14 in the gradient, 8.1e-15 in the Hessian)."""
    port, jax_vega = ports['grid_own'], setup['jax']
    alone = {'ap': 1.03, 'at': 0.97}
    _, grad_j = jax_vega.chi2_value_and_gradient(alone)
    hess_j = jax_vega.chi2_hessian(alone, list(alone))
    assert grad_j == {'ap': 0.0, 'at': 0.0}
    assert all(v == 0.0 for row in hess_j.values() for v in row.values())
    full = dict(alone, bias_LYA=port.params['bias_LYA'],
                beta_LYA=port.params['beta_LYA'])
    value, grad = port.chi2_value_and_gradient(alone)
    hess = port.chi2_hessian(alone, list(alone))
    value_4, grad_4 = jax_vega.chi2_value_and_gradient(full)
    hess_4 = jax_vega.chi2_hessian(full, list(alone))
    assert max_rel(value, value_4) <= 1e-6
    assert max_rel([grad[n] for n in alone], [grad_4[n] for n in alone]) \
        <= 1e-6
    assert max_rel([[hess[a][b] for b in alone] for a in alone],
                   [[hess_4[a][b] for b in alone] for a in alone]) <= 1e-6


def test_dense_kernel_route_records_the_backward(setup, ports,
                                                 stub_kernels):
    """The dense chi^2's Hessian with the kernel route taken (stub
    kernels) equals the plain route's, and every combine of it went
    through the Functions: the transpose and d >= 1 kernels launched."""
    port, point = ports['dense'], POINTS[0]
    got = port.chi2_hessian(point, list(point), use_kernel=True)
    want = port.chi2_hessian(point, list(point), use_kernel=False)
    assert got == want
    assert stub_kernels[('Ft', 0)] > 0 and stub_kernels[('Ft', 1)] > 0
    assert stub_kernels[('F', 1)] > 0 and stub_kernels[('F', 2)] > 0
    value, grad = port.chi2_value_and_gradient(point, use_kernel=True)
    assert (value, grad) == port.chi2_value_and_gradient(point,
                                                         use_kernel=False)


# ----------------------------------------------------------------------
# 3. The fit
# ----------------------------------------------------------------------
@pytest.mark.parametrize('regime', ['grid_payload', 'dense'])
def test_minimize_matches_jax(setup, ports, monkeypatch, regime, capsys):
    """minimize() from the [sample] start against vega_tpu's: best-fit
    values within 1e-3 of their errors, errors within 1e-5 relative, fval
    within 1e-8 absolute (the noise-free minimum is ~0)."""
    port, jax_vega = ports[regime], setup['jax']
    if regime == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
        # a fresh vega_tpu interface: its jitted graphs were traced with
        # the grid payload
        jax_vega = JaxInterface(setup['main'])
    port.minimize()
    jax_vega.minimize()
    got, want = port.bestfit, jax_vega.bestfit
    for name in NAMES:
        assert abs(got.values[name] - want.values[name]) <= \
            1e-3 * want.errors[name]
        assert got.errors[name] == pytest.approx(want.errors[name],
                                                 rel=1e-5)
    assert abs(got.fmin.fval - want.fmin.fval) <= 1e-8
    assert got.fmin.is_valid and not got.fmin.hesse_failed
    np.testing.assert_allclose(np.array(got.covariance),
                               np.array(want.covariance), rtol=1e-4,
                               atol=1e-4 * np.max(np.abs(np.array(
                                   want.covariance))))
    assert port.chisq == got.fmin.fval
    assert set(port.bestfit_corr_stats) == {'lyaxlya', 'qsoxlya'}
    for name, stats in port.bestfit_corr_stats.items():
        want_stats = jax_vega.bestfit_corr_stats[name]
        assert stats['masked_size'] == want_stats['masked_size']
        assert stats['chisq'] == pytest.approx(want_stats['chisq'],
                                               abs=1e-8)
    assert 'Total chi^2/(ndata-nparam)' in capsys.readouterr().out


def test_analysis_is_not_ported(ports):
    with pytest.raises(NotImplementedError, match='item 8'):
        ports['grid_own'].analysis  # noqa: B018
