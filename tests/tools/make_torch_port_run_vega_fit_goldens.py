"""Write tests/data/torch_port_run_vega_fit_goldens.json: the JAX
package's (vega_tpu) dense fit on the CPU of the configuration that
chip_smoke.py's run_vega phase fits through `cli fit`:
synthetic-dr16-published-full with the components written
(make_jax_dr16_published_dataset(work, size='full', components=True,
sample=SAMPLE)), the six names of SAMPLE sampled and the other twelve of
the published fit at the configuration's values; VEGA_TPU_FACTORED=0
(the metals run unrolled with the components, so every name is served
densely either way). The fit's values, errors, chi^2 and validity, and
the tool's own run time, are kept.

Usage (from the repo root):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_run_vega_fit_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_run_vega_fit_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

# the BAO, Lya and HCD names of the published fit's [sample], with their
# entries there (examples/eBOSS_DR16/make_configs.py: 'True' takes the
# parameter's default limits, start and error)
SAMPLE = {'ap': 'True', 'at': 'True', 'bias_eta_LYA': 'True',
          'beta_LYA': 'True', 'bias_hcd': 'True', 'beta_hcd': 'True'}


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ['VEGA_TPU_FACTORED'] = '0'
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from jax_dr16pub_dataset import make_jax_dr16_published_dataset
    from vega_tpu.vega_interface import VegaInterface

    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_dr16_published_dataset(
            work, size='full', components=True, sample=SAMPLE)
        seconds['dataset'] = time.perf_counter() - t_start
        vega = VegaInterface(main_ini)
        names = list(vega.sample_params['limits'])
        assert names == list(SAMPLE) and vega.fiducial['save-components']
        t0 = time.perf_counter()
        vega.minimize()
        seconds['fit'] = time.perf_counter() - t0
        best = vega.bestfit
        fit = {'values': [float(best.values[n]) for n in names],
               'errors': [float(best.errors[n]) for n in names],
               'fval': float(best.fmin.fval),
               'is_valid': bool(best.fmin.is_valid)}
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'config': 'synthetic-dr16-published-full with components: '
                  "make_jax_dr16_published_dataset(work, size='full', "
                  'components=True, sample=SAMPLE)',
        'path': 'vega_tpu minimize(), CPU, f64, VEGA_TPU_FACTORED=0',
        'sample': SAMPLE, 'names': names, 'fit_dense': fit,
        'seconds': seconds,
        'command': 'JAX_PLATFORMS=cpu python '
                   'tests/tools/make_torch_port_run_vega_fit_goldens.py',
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s')


if __name__ == '__main__':
    main()
