#!/usr/bin/env python
"""Generate the DESI instrumental-systematics correlation table.

Counterpart of the reference's
vega/models/instrumental_systematics/write_desi_instrumental_syst_table.py:
simulate the sky-model white-noise correlation induced by the fiber
positioners by drawing random points inside the patrol disks and
histogramming their pair separations (pair count / rt is the induced
correlation shape). The positioner geometry is read from the
desi-positioners.csv metrology table; without it a hexagonal mock focal
plane is used (shape testing only).

    python -m vega_tpu_torch.scripts.write_desi_instrumental_syst_table \
        -o table.csv --seed 0

A copy of vega_tpu/scripts/write_desi_instrumental_syst_table.py (host
numpy), reading the metrology table
vega_tpu/models/instrumental_systematics/desi-positioners.csv by path:
the same arguments write the same file (tests/test_torch_config_tools.py).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from vega_tpu_torch.utils import find_file

COMOVING_DISTANCE = 3941.86  # Mpc/h at z = 2.4 (Om = 0.315, Or = 7.963e-5)


def load_positioners(path=None):
    if path is None:
        path = find_file('instrumental_systematics/desi-positioners.csv')
    table = np.genfromtxt(path, delimiter=',', names=True)
    return (table['FOCAL_PLANE_X_DEG'], table['FOCAL_PLANE_Y_DEG'],
            table['PATROL_RADIUS_DEG'])


def mock_positioners(n_side=20, pitch_deg=0.05, patrol_deg=0.018):
    """Hexagonal mock focal plane for testing without the metrology file."""
    xs, ys = [], []
    for i in range(n_side):
        for j in range(n_side):
            xs.append((i + 0.5 * (j % 2)) * pitch_deg)
            ys.append(j * pitch_deg * np.sqrt(3) / 2)
    xp = np.array(xs)
    yp = np.array(ys)
    return xp, yp, np.full(xp.size, patrol_deg)


def build_table(xp, yp, rpatrol, n_randoms=50000, seed=None,
                comoving_distance=COMOVING_DISTANCE):
    """Random-pairs simulation (reference: lines 41-103 of the upstream
    generator, same algorithm)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=n_randoms) * np.max(xp + rpatrol)
    y = rng.uniform(size=n_randoms) * np.max(yp + rpatrol)

    ok = np.zeros(n_randoms, dtype=bool)
    for xxp, yyp, rrp in zip(xp, yp, rpatrol):
        ok |= ((x - xxp) ** 2 + (y - yyp) ** 2) < rrp ** 2
    x, y = x[ok], y[ok]

    deg2mpc = comoving_distance * np.pi / 180.
    bins = np.linspace(0, 200, 51)
    h0 = np.zeros(bins.size - 1)
    for xx, yy in zip(x, y):
        d = np.sqrt((xx - x) ** 2 + (yy - y) ** 2) * deg2mpc
        t, _ = np.histogram(d, bins=bins)
        h0 += t

    ok = h0 > 0
    rt = (bins[:-1] + (bins[1] - bins[0]) / 2)[ok]
    xi = h0[ok] / rt  # random pair counts scale as rt

    # anchor points at rt = 0, one step past the last bin, and 1000 Mpc
    xi_at_0 = (xi[0] - xi[1]) / (rt[0] - rt[1]) * (0 - rt[0]) + xi[0]
    rt = np.concatenate([[0.], rt, [rt[-1] + bins[1] - bins[0], 1000.]])
    xi = np.concatenate([[xi_at_0], xi, [0., 0.]])
    xi /= np.max(xi)
    return rt, xi


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-o', '--out', type=str,
                        default='desi-instrument-syst-for-forest-auto-'
                                'correlation.csv')
    parser.add_argument('--positioners', type=str, default=None,
                        help='Path to the positioner metrology CSV')
    parser.add_argument('--n-randoms', type=int, default=50000)
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--mock-focal-plane', action='store_true',
                        help='Use a hexagonal mock focal plane (testing)')
    args = parser.parse_args(argv)

    if args.mock_focal_plane:
        xp, yp, rpatrol = mock_positioners()
    else:
        xp, yp, rpatrol = load_positioners(args.positioners)

    rt, xi = build_table(xp, yp, rpatrol, n_randoms=args.n_randoms,
                         seed=args.seed)

    with open(args.out, 'w') as f:
        f.write('RT,XI\n')
        for r, v in zip(rt, xi):
            f.write(f'{r},{v}\n')
    print(f'wrote {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
