"""Write tests/data/torch_port_grid_goldens.json: the JAX package's
(vega_tpu) grid-collapse chi^2 on the CPU at the 8 points of
make_torch_port_goldens.py, on the full synthetic auto+cross
configuration, make_synthetic_dataset(cross=True, size='full'), with its
defaults (32 x 32 Chebyshev nodes over ap, at in [0.75, 1.25], mode
budget 2e-4) and the exact f64 payload contractions (VEGA_TPU_DS_MATMUL=0).

Also recorded: the dense chi^2 at the same points (VEGA_TPU_FACTORED=0),
the JAX package's own max |grid - dense| there, and the retained modes
and SVD ranks of each correlation's payload. The PyTorch port's grid
chi^2 is held against these numbers on the GPU by chip_smoke.py.

Usage (from the repo root; the 1024-node sweep takes minutes):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_grid_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_grid_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

from make_torch_port_goldens import POINTS  # noqa: E402


def main():
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ.pop('VEGA_TPU_FACTORED', None)
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import numpy as np
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface

    batch = {k: np.asarray(v) for k, v in POINTS.items()}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_synthetic_dataset(work, cross=True, size='full')
        vega = VegaInterface(main_ini)
        t0 = time.perf_counter()
        payload = vega.get_collapsed(tuple(sorted(batch)))
        collapse_s = time.perf_counter() - t0
        grid = np.asarray(vega.chi2_batch(batch))
        os.environ['VEGA_TPU_FACTORED'] = '0'
        dense = np.asarray(VegaInterface(main_ini).chi2_batch(batch))
    for name, values in (('grid', grid), ('dense', dense)):
        if not np.all(np.isfinite(values)) or np.any(values >= 1e100):
            raise SystemExit(f'unexpected {name} chi2: {values}')
    spec = payload['__grid__']
    OUT.write_text(json.dumps({
        'config': "make_synthetic_dataset(workdir, cross=True, size='full')",
        'path': 'vega_tpu grid-collapse chi2_batch (defaults, '
                'VEGA_TPU_DS_MATMUL=0), CPU, f64',
        'dense_path': 'vega_tpu dense chi2_batch (VEGA_TPU_FACTORED=0)',
        'made_by': 'tests/tools/make_torch_port_grid_goldens.py',
        'grid': {'names': list(spec.names), 'lo': list(spec.lo),
                 'hi': list(spec.hi), 'degrees': list(spec.degrees),
                 'ref': list(spec.ref)},
        'payload': {
            name: {'modes_A': int(p['modes_A'].shape[1]),
                   'rank_A': int(p['B_A'].shape[1]),
                   'modes_sy': int(p['modes_sy'].shape[1]),
                   'rank_sy': int(p['B_sy'].shape[1]),
                   'terms': int(p['cref'].shape[0]),
                   'dc_max': float(p['dc_max'])}
            for name, p in payload.items() if name != '__grid__'},
        'params': POINTS,
        'chi2_grid': [float(c) for c in grid],
        'chi2_dense': [float(c) for c in dense],
        'max_abs_grid_minus_dense': float(np.max(np.abs(grid - dense))),
    }, indent=1) + '\n')
    print(f'wrote {OUT} (collapse {collapse_s:.1f} s): grid {grid}, '
          f'dense {dense}')


if __name__ == '__main__':
    main()
