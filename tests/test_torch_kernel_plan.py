"""The launch plan and the cost model of the spline + Legendre kernels
(vega_tpu_torch/ops/spline_combine.py), which chip_smoke.py's records
use, and the edge layouts chip_smoke.py holds the kernels to: pure
Python, checked here without a card. The kernels themselves run only on
the card (chip_smoke.py)."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vega_tpu_torch.ops import spline_combine as sc

REPO = Path(__file__).resolve().parents[1]
CU = REPO / 'vega_tpu_torch' / 'csrc' / 'spline_legendre_combine.cu'
N_ELL, N_KNOTS = 4, 814
TABLE_BYTES = 2 * N_ELL * N_KNOTS * 8       # y and m of one row: 52,096 B


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('n_b', [1, 2, 3, 7, 33, 96, 263, 264, 1024, 8192])
def test_every_query_in_exactly_one_tile(n_b):
    """At every M from 1 to 5000: tiles of whole chunks cover the row
    once, none empty, and B x tiles reaches the block target unless the
    tiles are single chunks already."""
    for n_q in range(1, 5001):
        tiles, tile_q = sc.launch_plan(n_b, n_q)
        assert tile_q % sc.THREADS == 0
        assert (tiles - 1) * tile_q < n_q <= tiles * tile_q
        chunks = -(-n_q // sc.THREADS)
        assert n_b * tiles >= min(sc.BLOCK_TARGET, n_b * chunks)


def test_tiles_cover_each_query_once():
    for n_b, n_q in [(1, 5000), (1, 2500), (3, 5001), (96, 5000), (2, 1)]:
        tiles, tile_q = sc.launch_plan(n_b, n_q)
        hits = np.zeros(n_q, dtype=int)
        for tile in range(tiles):
            hits[tile * tile_q:min(n_q, (tile + 1) * tile_q)] += 1
        assert np.all(hits == 1)


def test_plan_at_the_paths_layouts():
    assert sc.launch_plan(1, 5000) == (20, 256)        # a fit's launches
    assert sc.launch_plan(1, 2500) == (10, 256)
    assert sc.launch_plan(264, 5000) == (1, 5120)      # B fills the card
    assert sc.launch_plan(1024, 5000) == (1, 5120)     # dense chi2_batch
    tiles, _ = sc.launch_plan(96, 5000)                # the sweep's peak
    assert 96 * tiles >= sc.BLOCK_TARGET
    assert sc.launch_plan(1, 0) == (1, sc.THREADS)


def test_plan_constants_match_the_kernel_source():
    source = CU.read_text()
    assert f'constexpr int kThreads = {sc.THREADS};' in source
    assert f'constexpr int kMaxL = {sc.MAX_MULTIPOLES};' in source


# layouts: (primitive, order, B, L, N, G, coordinate rows, M, x shared,
# leg shared) and their bytes worked out by hand
HAND_BYTES = [
    # dense chi2_batch: 1024 rows, per-row x / leg, 48 B per query
    (('F', 0, 1024, N_ELL, N_KNOTS, 1, 1024, 5000, False, False),
     1024 * (TABLE_BYTES + 5000 * 48)),
    # the sweep's peak: 96 rows in groups of 3 over 32 coordinate rows
    (('F', 0, 96, N_ELL, N_KNOTS, 3, 32, 5000, False, False),
     96 * TABLE_BYTES + 32 * 5000 * 40 + 96 * 5000 * 8),
    # the sweep's smooth part: 3 rows, one shared coordinate row
    (('F', 0, 3, N_ELL, N_KNOTS, 1, 3, 5000, True, True),
     3 * TABLE_BYTES + 5000 * 40 + 3 * 5000 * 8),
    (('F', 1, 1, N_ELL, N_KNOTS, 1, 1, 5000, False, False),
     TABLE_BYTES + 5000 * 48),
    # S'' reads m alone
    (('F', 2, 1, N_ELL, N_KNOTS, 1, 1, 5000, False, False),
     TABLE_BYTES // 2 + 5000 * 48),
    # P_d: x in, L values out
    (('P', 0, 1, N_ELL, N_KNOTS, 1, 1, 5000, False, False),
     TABLE_BYTES + 5000 * 40),
    # Ft_d: g, x, leg in, both tables out
    (('Ft', 1, 1, N_ELL, N_KNOTS, 1, 1, 5000, False, False),
     TABLE_BYTES + 5000 * 48),
]


@pytest.mark.parametrize('key,want', HAND_BYTES,
                         ids=[f'{k[0]}_{k[1]}-B{k[2]}-M{k[7]}'
                              for k, _ in HAND_BYTES])
def test_launch_bytes_by_hand(key, want):
    """Each input read once, each output written once, plus the knots."""
    assert sc.launch_bytes(*key) == want + N_KNOTS * 8
    bound_ms, bound_by = sc.launch_bound(*key)
    assert bound_by == 'bytes'
    assert bound_ms == pytest.approx(1e3 * (want + N_KNOTS * 8) / 3.35e12)


def test_bounds_of_the_dense_and_sweep_layouts():
    """299.2 MB, 89.3 us at dense B = 1024, M = 5000; 15.2 MB at the
    sweep's B = 96, G = 3."""
    dense, sweep = HAND_BYTES[0][0], HAND_BYTES[1][0]
    assert sc.launch_bytes(*dense) / 1e6 == pytest.approx(299.2, abs=0.1)
    assert sc.launch_bound(*dense)[0] == pytest.approx(0.0893, abs=1e-4)
    assert sc.launch_bytes(*sweep) / 1e6 == pytest.approx(15.2, abs=0.1)


def test_operations_bound_a_layout_heavy_in_flops():
    """bound_by says which rate bounds: an absurd flop count per query
    (a patched cost) flips a layout to 'operations'."""
    key = HAND_BYTES[0][0]
    flops = dict(sc.MULTIPOLE_FLOPS, F=10_000)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sc, 'MULTIPOLE_FLOPS', flops)
        assert sc.launch_bound(*key)[1] == 'operations'


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernel route on CPU tensors; each stub kernel records the
    launch arguments it was handed and writes the plain version."""
    calls = []
    monkeypatch.setattr(sc, '_kernel_route',
                        lambda device, use_kernel: use_kernel)

    def forward(grid, y, m, x, leg, out, order, group, x_rs, leg_rs, plan):
        calls.append(('F', plan, None))
        out.copy_(sc.spline_legendre_combine_reference(grid, y, m, x, leg,
                                                       group, order))

    def transpose(grid, g, x, leg, out_y, out_m, scratch, order, x_rs,
                  leg_rs, plan):
        calls.append(('Ft', plan, None if scratch is None
                      else tuple(scratch.shape)))
        for out, ref in zip((out_y, out_m),
                            sc.spline_legendre_transpose_reference(
                                grid, g, x, leg, order)):
            out.copy_(ref)

    monkeypatch.setattr(sc, '_forward_kernel', forward)
    monkeypatch.setattr(sc, '_transpose_kernel', transpose)
    return calls


def small_inputs(n_b, n_q, seed=0):
    rng = np.random.default_rng(seed)
    knots = np.linspace(-2.0, 5.0, 40)
    grid = sc.KnotGrid.build(knots, 'cpu')
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    y = t(rng.normal(size=(n_b, N_ELL, len(knots))))
    m = t(rng.normal(size=(n_b, N_ELL, len(knots))))
    x = t(rng.uniform(-2.2, 5.2, (n_b, n_q)))
    leg = t(rng.uniform(-1, 1, (n_b, N_ELL, n_q)))
    g = t(rng.uniform(-1, 1, (n_b, n_q)))
    return grid, y, m, x, leg, g


def test_transpose_takes_scratch_for_split_rows(plain_kernels):
    """A row split into tiles hands the kernel (B, tiles, 2, L, N)
    scratch; a row in one tile writes straight into the outputs."""
    grid, _, _, x, leg, g = small_inputs(1, 600)
    sc.combine_transpose(grid, g, x, leg, order=1)
    grid, _, _, x, leg, g = small_inputs(300, 10)
    sc.combine_transpose(grid, g, x, leg)
    assert plain_kernels == [('Ft', (3, 256), (1, 3, 2, N_ELL, 40)),
                             ('Ft', (1, 256), None)]


def test_recorded_layouts_count_their_launches(plain_kernels):
    grid, y, m, x, leg, _ = small_inputs(2, 30)
    with sc.recorded_launches() as layouts:
        for _ in range(3):
            sc.combine_forward(grid, y, m, x, leg)
        sc.combine_forward(grid, y[:1], m[:1], x[:1], leg[:1], order=2)
    key = ('F', 0, 2, N_ELL, 40, 1, 2, 30, False, False)
    assert layouts[key].launches == 3 and layouts[key].grid is grid
    assert layouts[('F', 2, 1, N_ELL, 40, 1, 1, 30, False,
                    False)].launches == 1
    assert len(layouts) == 2


def test_nested_recorders_leave_by_identity(plain_kernels):
    """A recorder nested in another, whose launches are all the outer one
    has seen (equal dicts when it closes), leaves the outer one recording:
    a later launch counts there, and both close."""
    grid, y, m, x, leg, _ = small_inputs(2, 30)
    key = ('F', 0, 2, N_ELL, 40, 1, 2, 30, False, False)
    with sc.recorded_launches() as outer:
        with sc.recorded_launches() as inner:
            sc.combine_forward(grid, y, m, x, leg)
        assert inner == outer
        sc.combine_forward(grid, y, m, x, leg)
    assert outer[key].launches == 2 and inner[key].launches == 1
    assert sc._recorders == []


def test_kernel_route_refuses_too_many_multipoles(plain_kernels):
    grid, y, m, x, _, _ = small_inputs(1, 5)
    wide = [torch.cat([a] * 3, dim=1) for a in (y, m)]
    leg = torch.ones((1, 3 * N_ELL, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match='multipoles'):
        sc.combine_forward(grid, *wide, x, leg)
    out = sc.combine_forward(grid, *wide, x, leg, use_kernel=False)
    assert out.shape == (1, 5)


EDGE_LABELS = ['every query on a knot', 'every query in one interval',
               'M not a multiple of the tile (odd M)',
               'M not a multiple of the tile (even M)', 'B = 1, M = 1',
               'a row with every query out of range']


@pytest.fixture(scope='module')
def edge_cases():
    knots = np.log(np.logspace(-1, 3, 100))
    grid = sc.KnotGrid.build(knots, 'cpu')
    return grid, chip_smoke().edge_cases(np.random.default_rng(1), 'cpu',
                                         grid, N_ELL)


def test_edge_cases_are_what_they_say(edge_cases):
    grid, cases = edge_cases
    knots = grid.tensor
    assert [label for label, _, _ in cases] == EDGE_LABELS
    by_label = {label: (layout, inputs) for label, layout, inputs in cases}
    _, (_, _, x, _, _) = by_label['every query on a knot']
    assert torch.isin(x, knots).all()
    assert (x == knots[0]).any() and (x == knots[-1]).any()
    _, (_, _, x, _, _) = by_label['every query in one interval']
    j = torch.searchsorted(knots, x, right=True)
    assert torch.all(j == j.flatten()[0])
    for label in EDGE_LABELS[2:4]:
        layout, _ = by_label[label]
        tiles, tile_q = sc.launch_plan(layout[0], layout[5])
        assert tiles > 1 and layout[5] % tile_q
    assert by_label[EDGE_LABELS[2]][0][5] % 2 == 1
    assert by_label[EDGE_LABELS[3]][0][5] % 2 == 0
    assert by_label['B = 1, M = 1'][0][0] == 1
    assert by_label['B = 1, M = 1'][0][5] == 1
    _, (_, _, x, _, _) = by_label['a row with every query out of range']
    assert torch.all((x[1] < knots[0]) | (x[1] > knots[-1]))
    assert torch.any(x[1] < knots[0]) and torch.any(x[1] > knots[-1])


@pytest.mark.parametrize('label', EDGE_LABELS)
def test_plain_versions_at_the_edge_cases(edge_cases, label):
    """The plain versions the kernels are held to at each edge layout:
    finite, and the transpose the adjoint of the forward."""
    grid, cases = edge_cases
    _, layout, (y, m, x, leg, g) = next(c for c in cases if c[0] == label)
    for order in range(4):
        out = sc.combine_forward(grid, y, m, x, leg, order=order)
        ybar, mbar = sc.combine_transpose(grid, g, x, leg, order=order)
        assert torch.isfinite(out).all()
        lhs = float(torch.sum(ybar * y) + torch.sum(mbar * m))
        assert lhs == pytest.approx(float(torch.sum(g * out)), rel=1e-11,
                                    abs=1e-11)
