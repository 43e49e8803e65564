"""Write tests/data/torch_port_goldens.json: chi^2 of the JAX package
(vega_tpu) on the CPU, dense path (VEGA_TPU_FACTORED=0), at 8 fixed
(ap, at, bias_LYA, beta_LYA) points of the full synthetic auto+cross
configuration, make_synthetic_dataset(cross=True, size='full').

The PyTorch port is held against these numbers where JAX is absent:
chip_smoke.py on the GPU, and tests/test_torch_interface.py on the CPU.

Usage (from the repo root):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_goldens.json'

# 8 fixed points around the defaults (ap = at = 1, bias_LYA = -0.117,
# beta_LYA = 1.67), all inside the knot range of the transform
POINTS = {
    'ap': [1.0, 1.02, 0.97, 1.05, 0.95, 1.01, 0.99, 1.08],
    'at': [1.0, 0.98, 1.03, 1.04, 0.96, 1.0, 1.02, 0.93],
    'bias_LYA': [-0.12, -0.117, -0.11, -0.125, -0.117, -0.114, -0.119,
                 -0.121],
    'beta_LYA': [1.67, 1.7, 1.6, 1.75, 1.64, 1.67, 1.69, 1.58],
}


def main():
    os.environ['VEGA_TPU_FACTORED'] = '0'
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import numpy as np
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface

    with tempfile.TemporaryDirectory() as work:
        vega = VegaInterface(make_synthetic_dataset(work, cross=True,
                                                    size='full'))
        chi2 = np.asarray(vega.chi2_batch(
            {k: np.asarray(v) for k, v in POINTS.items()}))
    if not np.all(np.isfinite(chi2)) or np.any(chi2 >= 1e100):
        raise SystemExit(f'unexpected chi2: {chi2}')
    OUT.write_text(json.dumps({
        'config': "make_synthetic_dataset(workdir, cross=True, size='full')",
        'path': 'vega_tpu dense chi2_batch (VEGA_TPU_FACTORED=0), CPU, f64',
        'made_by': 'tests/tools/make_torch_port_goldens.py',
        'params': POINTS,
        'chi2': [float(c) for c in chi2],
    }, indent=1) + '\n')
    print(f'wrote {OUT}: {chi2}')


if __name__ == '__main__':
    main()
