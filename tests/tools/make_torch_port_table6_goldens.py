"""Write tests/data/torch_port_table6_goldens.json: the JAX package's
(vega_tpu) dense numbers on the CPU for the configuration
synthetic-dr16-table6-full, the DR16-shaped full synthetic auto+cross
dataset (tests/tools/jax_metal_dataset.py with
vega_tpu_torch.testing.dr16_extra_model() and DR16_METALS) with eBOSS
DR16's 13 combined-fit names sampled (vega_tpu_torch.testing.
TABLE6_SAMPLE), on the dense path (VEGA_TPU_FACTORED=0):

- chi2_batch at 8 seeded points with all 13 names varied inside the grid
  domain (ap, at 1% around 1, drp_QSO in [-0.5, 0.5],
  sigma_velo_disp_lorentz_QSO 6.86 +- 1, the linear names 1% around the
  truth);
- chi2_value_and_gradient at the first two of them;
- the tool's own run time, by part.

vega_tpu's 4-dimension grid payload of this configuration (7,737 swept
nodes) is not built here: it took 6,675.6 s on one host core
(benchmarks/table6_accuracy.json) and holds tens of GB of sweep
temporaries. The PyTorch port is held against these numbers on the GPU
by chip_smoke.py (its table6 phase): its grid chi^2 against the dense
chi^2 within the node-convergence floor, its dense chi^2 within 1e-8.

Usage (from the repo root; about 2 minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_table6_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_table6_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

N_POINTS = 8
N_GRADIENTS = 2


def draw_points(truth, n_rows):
    """Rows inside the grid domain: ap, at 1% around 1, drp_QSO uniform
    in [-0.5, 0.5], sigma_velo_disp_lorentz_QSO 6.86 +- 1 (normal), the
    other names 1% around the truth."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = {}
    for name, val in truth.items():
        if name == 'drp_QSO':
            out[name] = rng.uniform(-0.5, 0.5, n_rows)
        elif name == 'sigma_velo_disp_lorentz_QSO':
            out[name] = val + rng.normal(size=n_rows)
        else:
            out[name] = val + 0.01 * abs(val) * rng.normal(size=n_rows)
    return {k: v.tolist() for k, v in out.items()}


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_FACTORED'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import numpy as np
    from jax_metal_dataset import make_jax_metal_dataset
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import (DR16_METALS, TABLE6_SAMPLE,
                                        dr16_extra_model)

    names = sorted(TABLE6_SAMPLE)
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_metal_dataset(
            work, list(DR16_METALS), cross=True, size='full',
            sample=TABLE6_SAMPLE, extra_model=dr16_extra_model())
        seconds['dataset'] = time.perf_counter() - t_start
        vega = VegaInterface(main_ini)
        truth = {n: float(vega.params[n]) for n in names}
        points = draw_points(truth, N_POINTS)
        t0 = time.perf_counter()
        chi2 = np.asarray(vega.chi2_batch(
            {k: np.asarray(v) for k, v in points.items()}))
        seconds['dense_chi2_batch'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gradients = []
        for i in range(N_GRADIENTS):
            value, grad = vega.chi2_value_and_gradient(
                {n: points[n][i] for n in names})
            gradients.append({'chi2': value,
                              'gradient': [grad[n] for n in names]})
        seconds['dense_gradients'] = time.perf_counter() - t0
        chi2_truth = float(vega.chi2(truth))
    if not np.all(np.isfinite(chi2)) or np.any(chi2 >= 1e100):
        raise SystemExit(f'unexpected dense chi2: {chi2}')
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'config': 'synthetic-dr16-table6-full: make_jax_metal_dataset(work, '
                  "DR16_METALS, cross=True, size='full', "
                  'sample=TABLE6_SAMPLE, extra_model=dr16_extra_model())',
        'names': names, 'sample': TABLE6_SAMPLE, 'truth': truth,
        'path': 'vega_tpu chi2_batch / chi2_value_and_gradient, CPU, f64, '
                'VEGA_TPU_FACTORED=0 (dense)',
        'made_by': 'tests/tools/make_torch_port_table6_goldens.py',
        'params': points,
        'chi2_dense': [float(c) for c in chi2],
        'chi2_truth': chi2_truth,
        'gradients': gradients,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}; chi2 '
          f'{chi2.tolist()}')


if __name__ == '__main__':
    main()
