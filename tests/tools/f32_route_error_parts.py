"""Where the f32 grid route's chi^2 error comes from, on tiny
synthetic-dr16-published at the full configuration's payload spec (32 x
32 x 12 x 12 nodes over ap, at, drp_QSO, sigma_velo_disp_lorentz_QSO):
the port's payload swept in f64 and in f32, and the crosses' per-row
chi^2 = s - 2 dc.y + dc.A dc evaluated with each part (the data term s,
the cross term y, the quadratic A, the coefficient offsets dc) taken
from the f32 side and the rest from the f64 side, once for the sweep
(the f32 payload evaluated in f64) and once for the evaluation (the f64
payload evaluated in f32). Prints each part's share of the error, and
the sum of |Chebyshev coefficients| of s against s.

Usage (from the repo root; about 2 minutes on 8 cores):
    python tests/tools/f32_route_error_parts.py [--work DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def parts(payload, tvecs, coeffs, dtype):
    """(dc, A, y, s) of one correlation's payload, evaluated in dtype."""
    import numpy as np
    import torch
    from vega_tpu_torch import gridcollapse as gc
    p = {k: torch.as_tensor(np.asarray(payload[k]), dtype=torch.int64
                            if k.startswith('modes') else dtype)
         for k in ('B_A', 'F_A', 'modes_A', 'B_sy', 'F_sy', 'modes_sy',
                   'cref')}
    tvecs = [t.to(dtype) for t in tvecs]
    t = p['cref'].shape[0]
    dc = coeffs.to(dtype) - p['cref']
    a_mat = ((gc.psi_from_modes(tvecs, p['modes_A']) @ p['B_A'])
             @ p['F_A']).reshape(-1, t, t)
    p_sy = (gc.psi_from_modes(tvecs, p['modes_sy']) @ p['B_sy']) @ p['F_sy']
    return [x.double() for x in (dc, a_mat, p_sy[:, :t], p_sy[:, t])]


def chi2(dc, a_mat, y, s):
    import torch
    return (s - 2.0 * torch.sum(dc * y, dim=-1)
            + torch.sum(dc * (a_mat @ dc[..., None])[..., 0], dim=-1))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--work', default=None)
    args = parser.parse_args()
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    import numpy as np
    import torch
    from make_torch_port_dr16pub_goldens import NAMES, draw_points
    from make_torch_port_f32_models_goldens import make_tiny_route
    from vega_tpu_torch import gridcollapse as gc
    from vega_tpu_torch.vega_interface import VegaInterface

    with tempfile.TemporaryDirectory() as tmp:
        main_ini = make_tiny_route(Path(args.work or tmp) / 'route')
        vegas, payloads = {}, {}
        for dtype in (torch.float64, torch.float32):
            vegas[dtype] = VegaInterface(main_ini, device='cpu', dtype=dtype)
            payloads[dtype] = vegas[dtype].get_collapsed(frozenset(NAMES))
    vega = vegas[torch.float64]
    spec = payloads[torch.float64]['__grid__']
    local, n_b = vega._batch_params(draw_points(8))
    tvecs, _ = gc.grid_tvecs(spec, vega._grid_values(local, spec, -1), n_b)
    ref = dict(local)
    ref.update(zip(spec.names, spec.ref))
    ref = vega._grid_values(ref, spec, +1)
    for name in sorted(set(payloads[torch.float64]) - {'__grid__'}):
        coeffs = vega.models[name].coefficients(ref, n_b)
        exact = parts(payloads[torch.float64][name], tvecs, coeffs,
                      torch.float64)
        base = chi2(*exact)
        print(f'{name}: chi2 {np.round(base.numpy(), 4).tolist()}')
        for side, other in (
                ('sweep (f32 payload, f64 evaluation)',
                 parts(payloads[torch.float32][name], tvecs, coeffs,
                       torch.float64)),
                ('evaluation (f64 payload, f32 evaluation)',
                 parts(payloads[torch.float64][name], tvecs, coeffs,
                       torch.float32))):
            total = float((chi2(*other) - base).abs().max())
            shares = []
            for i, label in enumerate(('dc', 'A', 'y', 's')):
                mixed = list(exact)
                mixed[i] = other[i]
                err = float((chi2(*mixed) - base).abs().max())
                shares.append(f'{label} {err:.3g}')
            print(f'  {side}: max |d chi2| {total:.3g}; from one part '
                  'alone: ' + ', '.join(shares))
        p = payloads[torch.float64][name]
        c_s = np.asarray(p['B_sy']) @ np.asarray(p['F_sy'])[:, -1]
        print(f'  sum |Chebyshev coefficients of s| {np.abs(c_s).sum():.4g}, '
              f's at the rows {np.round(exact[3].numpy(), 3).tolist()}')


if __name__ == '__main__':
    main()
