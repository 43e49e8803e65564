"""Write tests/data/torch_port_f32_goldens.json: the JAX package's
(vega_tpu) f32 throughput mode (VEGA_TPU_X64=0) on the CPU, on the full
synthetic auto+cross configuration with (ap, at, bias_LYA, beta_LYA)
sampled, make_synthetic_dataset(cross=True, size='full', sample=SAMPLE)
of make_torch_port_fit_goldens.py:

- the dense chi^2 (VEGA_TPU_FACTORED=0) at the 8 points of
  make_torch_port_goldens.py;
- the grid-collapse chi^2 at the same points (the defaults: 32 x 32
  Chebyshev nodes, exact payload contractions, VEGA_TPU_DS_MATMUL=0),
  with the payload's modes and ranks;
- minimize() from the [sample] start on both paths: best-fit values,
  errors, fval, validity and wall time;
- beside them, vega_tpu's f64 dense and grid chi^2 at the same points on
  the same dataset (the f64 mode, this process).

The dataset is written in f64 by this process, as the port writes it;
the f32 numbers come from a subprocess under VEGA_TPU_X64=0, as
tests/test_f32_mode.py runs the f32 mode (the x64 switch is read when
vega_tpu is imported). The PyTorch port's f32 mode is held against these
numbers on the CPU (tests/test_torch_f32_path.py) and on the GPU
(chip_smoke.py's f32 phase), within vega_tpu's f32 ladder.

Usage (from the repo root; a few minutes on 8 cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_f32_goldens.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_f32_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

from make_torch_port_fit_goldens import NAMES, SAMPLE  # noqa: E402
from make_torch_port_goldens import POINTS  # noqa: E402

F32_SCRIPT = r"""
import json, os, sys, time
os.environ['VEGA_TPU_X64'] = '0'
os.environ['VEGA_TPU_DS_MATMUL'] = '0'
os.environ['VEGA_TPU_GRID_CACHE'] = '0'
os.environ.pop('VEGA_TPU_FACTORED', None)
os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', False)
import numpy as np
from vega_tpu.vega_interface import VegaInterface

main_ini, points, names = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])
batch = {k: np.asarray(v) for k, v in points.items()}


def fit(vega):
    t0 = time.perf_counter()
    vega.minimize()
    seconds = time.perf_counter() - t0
    best = vega.bestfit
    return {'values': [best.values[n] for n in names],
            'errors': [best.errors[n] for n in names],
            'fval': float(best.fmin.fval),
            'is_valid': bool(best.fmin.is_valid), 'seconds': seconds}


out = {}
t0 = time.perf_counter()
grid_vega = VegaInterface(main_ini)
payload = grid_vega.get_collapsed(tuple(sorted(batch)))
out['collapse_s'] = time.perf_counter() - t0
grid = np.asarray(grid_vega.chi2_batch(batch))
out['dtype'] = str(grid.dtype)
out['chi2_grid'] = [float(c) for c in grid]
out['payload'] = {
    name: {'modes_A': int(p['modes_A'].shape[1]),
           'rank_A': int(p['B_A'].shape[1]),
           'modes_sy': int(p['modes_sy'].shape[1]),
           'rank_sy': int(p['B_sy'].shape[1]),
           'terms': int(p['cref'].shape[0])}
    for name, p in payload.items() if name != '__grid__'}
out['fit_grid'] = fit(grid_vega)
# vega_tpu reads VEGA_TPU_FACTORED when it traces a call: keep it set
os.environ['VEGA_TPU_FACTORED'] = '0'
dense_vega = VegaInterface(main_ini)
out['chi2_dense'] = [float(c) for c in
                     np.asarray(dense_vega.chi2_batch(batch))]
out['fit_dense'] = fit(dense_vega)
print(json.dumps(out))
"""


def main():
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import numpy as np
    from vega_tpu.testing import make_synthetic_dataset

    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    from vega_tpu.vega_interface import VegaInterface

    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ.pop('VEGA_TPU_FACTORED', None)
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    batch = {k: np.asarray(v) for k, v in POINTS.items()}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_synthetic_dataset(work, cross=True, size='full',
                                          sample=SAMPLE)
        f64 = {'chi2_grid_f64': np.asarray(
            VegaInterface(main_ini).chi2_batch(batch))}
        os.environ['VEGA_TPU_FACTORED'] = '0'
        f64['chi2_dense_f64'] = np.asarray(
            VegaInterface(main_ini).chi2_batch(batch))
        del os.environ['VEGA_TPU_FACTORED']
        proc = subprocess.run(
            [sys.executable, '-c', F32_SCRIPT, str(main_ini),
             json.dumps(POINTS), json.dumps(list(NAMES))],
            capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out['dtype'] != 'float32':
        raise SystemExit(f'the subprocess ran in {out["dtype"]}, not f32')
    for name in ('chi2_grid', 'chi2_dense'):
        values = np.asarray(out[name])
        if not np.all(np.isfinite(values)):
            raise SystemExit(f'unexpected {name}: {values}')
    OUT.write_text(json.dumps({
        'config': "make_synthetic_dataset(workdir, cross=True, "
                  "size='full', sample=SAMPLE) (written in f64)",
        'names': list(NAMES), 'sample': SAMPLE, 'params': POINTS,
        'path': 'vega_tpu under VEGA_TPU_X64=0 (f32), CPU, '
                'VEGA_TPU_DS_MATMUL=0',
        'grid_path': 'defaults (grid collapse, 32 x 32 nodes)',
        'dense_path': 'VEGA_TPU_FACTORED=0',
        'made_by': 'tests/tools/make_torch_port_f32_goldens.py',
        **{k: out[k] for k in ('chi2_dense', 'chi2_grid', 'payload',
                               'fit_dense', 'fit_grid')},
        **{k: [float(c) for c in v] for k, v in f64.items()},
        'seconds_on_the_cpu': {'collapse': out['collapse_s'],
                               'tool': time.perf_counter() - t_start},
    }, indent=1) + '\n')
    print(f'wrote {OUT}: dense {out["chi2_dense"]}, grid '
          f'{out["chi2_grid"]}, dense fit {out["fit_dense"]["values"]}, '
          f'grid fit {out["fit_grid"]["values"]}')


if __name__ == '__main__':
    main()
