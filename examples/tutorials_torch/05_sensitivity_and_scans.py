"""Tutorial 5 — Fisher sensitivity and chi^2 profile scans, with the
PyTorch port (vega_tpu_torch) on the GPU.

Counterpart of examples/tutorials/05_sensitivity_and_scans.py, plus the
batched on-device scan (every grid point of a profile scan minimized at
once: the serial MIGRAD re-minimization loop of the reference becomes
one batched Newton optimization, sharded over the device mesh).

Run:  python 05_sensitivity_and_scans.py [--device cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse   # noqa: E402
import tempfile   # noqa: E402

import numpy as np   # noqa: E402

from vega_tpu_torch.parallel import batched_chi2_scan       # noqa: E402
from vega_tpu_torch.testing import make_synthetic_dataset   # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface     # noqa: E402


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    args = pars.parse_args(argv)

    workdir = tempfile.mkdtemp(prefix='vega_tutorial_')
    vega = VegaInterface(make_synthetic_dataset(workdir, cross=False,
                                                size='tiny',
                                                device=args.device),
                         device=args.device)
    vega.minimize()

    # --- Exact Fisher sensitivity (autograd, no finite differences) ----
    vega.compute_sensitivity_exact(verbose=False)
    sens = vega.sensitivity
    part = sens['partials']['lyaxlya']['bias_LYA']
    print(f'd(model)/d(bias_LYA): {part.shape} '
          '(distorted/undistorted x peak/smooth x bins)')
    fisher = sens['fisher']['lyaxlya'][('bias_LYA', 'beta_LYA')]
    print(f'Fisher(bias, beta) along rp: {fisher.shape}')

    # --- 1D profile scan: all grid points minimized at once ------------
    grid = {'bias_LYA': np.linspace(-0.125, -0.109, 9)}
    results = batched_chi2_scan(vega, grid)
    print('\nbias_LYA profile:')
    for row in results[::2]:
        print(f'  bias = {row["bias_LYA"]:+.4f} -> '
              f'chi2 = {row["fval"]:.3f} (beta profiled to '
              f'{row["beta_LYA"]:.3f})')

    best = min(results, key=lambda r: r['fval'])
    print(f'profile minimum at bias = {best["bias_LYA"]:+.4f}')

    # The same runs through the config surface: a [chi2 scan] section in
    # main.ini makes run_vega call Analysis.chi2_scan (batched by
    # default).
    return {'partial_shape': list(part.shape),
            'partial_norm': float(np.linalg.norm(part)),
            'fisher_shape': list(np.shape(fisher)),
            'fisher_sum': float(np.nansum(fisher)),
            'scan': [{k: float(v) for k, v in row.items()}
                     for row in results],
            'best_bias': float(best['bias_LYA'])}


if __name__ == '__main__':
    main()
