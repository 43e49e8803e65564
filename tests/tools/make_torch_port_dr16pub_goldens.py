"""Write tests/data/torch_port_dr16pub_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for the configuration
synthetic-dr16-published-full: eBOSS DR16's combined fit as
examples/eBOSS_DR16/make_configs.py builds it (four correlations,
old_fftlog, old_growth_func, the sky-residual broadband in both autos,
binsize 4, five metals with CIV(eff), the 18 sampled names) on synthetic
data at full size (tests/tools/jax_dr16pub_dataset.py), all on the dense
path (VEGA_TPU_FACTORED=0):

- chi2_batch at 8 points drawn 1% around the truth;
- chi2_value_and_gradient at DERIVATIVE_POINTS;
- minimize() from the [sample] start: best-fit values, errors, fval,
  EDM, validity and wall time;
- the tool's own run time, by part.

vega_tpu's own grid route for these names (a 4-dimension payload over
ap, at, drp_QSO and sigma_velo_disp_lorentz_QSO) takes hours at full
size on the CPU and is not built here; tests/test_torch_dr16_published.py
holds the port's route against vega_tpu's at size='tiny'. The PyTorch
port is held against these numbers on the GPU by chip_smoke.py (its
dr16pub phase).

Usage (from the repo root; about 25 minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_dr16pub_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_dr16pub_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

# the truth of the sampled names: the configuration's parameters
# (make_configs.py:96-121 and its sky defaults)
TRUTH = {
    'ap': 1.0, 'at': 1.0, 'bias_eta_LYA': -0.201, 'beta_LYA': 1.669,
    'bias_hcd': -0.0523, 'beta_hcd': 0.646,
    'bias_eta_SiII(1260)': -0.0027, 'bias_eta_SiIII(1207)': -0.0045,
    'bias_eta_SiII(1193)': -0.002, 'bias_eta_SiII(1190)': -0.0029,
    'bias_eta_CIV(eff)': -0.0052, 'drp_QSO': 0.0,
    'sigma_velo_disp_lorentz_QSO': 6.86, 'beta_QSO': 0.26,
    'BB-lyaxlya-0-broadband_sky-scale-sky': 0.01,
    'BB-lyaxlya-0-broadband_sky-sigma-sky': 31.0,
    'BB-lyaxlyb-0-broadband_sky-scale-sky': 0.01,
    'BB-lyaxlyb-0-broadband_sky-sigma-sky': 31.0,
}
NAMES = tuple(TRUTH)
N_POINTS = 8


def draw_points(n_rows, seed=0, width=0.01):
    """Rows `width` (relative) around the truth (width x 0.1 around 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {name: (val + width * (abs(val) or 0.1)
                   * rng.normal(size=n_rows)).tolist()
            for name, val in TRUTH.items()}


def derivative_points():
    """Two points 3% around the truth, one name per row of a draw."""
    rows = draw_points(2, seed=1, width=0.03)
    return [{name: rows[name][i] for name in NAMES} for i in range(2)]


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ['VEGA_TPU_FACTORED'] = '0'
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import numpy as np
    from jax_dr16pub_dataset import make_jax_dr16_published_dataset
    from vega_tpu.vega_interface import VegaInterface

    points = draw_points(N_POINTS)
    batch = {k: np.asarray(v) for k, v in points.items()}
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_dr16_published_dataset(work, size='full')
        seconds['dataset'] = time.perf_counter() - t_start
        vega = VegaInterface(main_ini)
        assert tuple(vega.sample_params['limits']) == NAMES
        t0 = time.perf_counter()
        chi2 = np.asarray(vega.chi2_batch(batch))
        seconds['chi2_batch'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        deriv = {'points': derivative_points(), 'chi2': [], 'gradient': []}
        for point in deriv['points']:
            value, grad = vega.chi2_value_and_gradient(point)
            deriv['chi2'].append(value)
            deriv['gradient'].append([grad[n] for n in NAMES])
        seconds['derivatives'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vega.minimize()
        seconds['fit'] = time.perf_counter() - t0
        best = vega.bestfit
        fit = {'values': [best.values[n] for n in NAMES],
               'errors': [best.errors[n] for n in NAMES],
               'fval': float(best.fmin.fval), 'edm': float(best.fmin.edm),
               'is_valid': bool(best.fmin.is_valid),
               'seconds': seconds['fit']}
    if not np.all(np.isfinite(chi2)) or np.any(chi2 >= 1e100):
        raise SystemExit(f'unexpected chi2: {chi2}')
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'config': 'synthetic-dr16-published-full: '
                  "make_jax_dr16_published_dataset(work, size='full')",
        'names': list(NAMES),
        'path': 'vega_tpu chi2_batch / chi2_value_and_gradient / '
                'minimize(), CPU, f64, VEGA_TPU_FACTORED=0',
        'points': points, 'chi2_dense': chi2.tolist(),
        'derivatives': deriv, 'fit_dense': fit,
        'seconds': seconds,
        'command': 'JAX_PLATFORMS=cpu python '
                   'tests/tools/make_torch_port_dr16pub_goldens.py',
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s')


if __name__ == '__main__':
    main()
