"""Write tests/data/torch_port_run_vega_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for chip_smoke.py's run_vega phase, on
synthetic-dr16-published-full with the components written
(make_jax_dr16_published_dataset(work, size='full', components=True):
[output] write_pk / write_cf, fast_metals and fast_metal_bias off in
each [model], the departure the two packages' errors ask for), all on
the dense path (VEGA_TPU_FACTORED=0; vega_tpu's route for the 18 names
sweeps its payload and finds nothing factored once the metals run
unrolled, then serves them densely):

- compute_model at POINT, the dense best fit of
  tests/data/torch_port_dr16pub_goldens.json: the returned model and
  every saved component of each correlation (pk, xi, xi_distorted;
  peak, smooth, full), the metal pairs' own (model.metals, under
  'metals/') among them;
- compute_sensitivity_exact over the 18 names at the nominal (that best
  fit and its errors): each partial and the Fisher sums (with the sums
  of the bins' absolute values);
- compute_sensitivity over FD_NAMES at the same nominal (frac 0.1, 8
  rebuilds), the other sampled names at POINT: each partial and the
  Fisher sums;
- the tool's own run time, by part.

The grids are too large for JSON, so each vector is summarised by
`summary`: its size, norm, max|x| and its values at N_INDEX fixed
indices.

Usage (from the repo root):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_run_vega_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_run_vega_goldens.json'
DR16PUB = REPO / 'tests' / 'data' / 'torch_port_dr16pub_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

N_INDEX = 64
FD_NAMES = ('ap', 'at', 'bias_eta_LYA', 'beta_LYA')
COMPONENTS = ('pk', 'xi', 'xi_distorted')
PARTS = ('peak', 'smooth', 'full')


def summary(x):
    """{size, norm, max_abs, index, values}: a vector (any shape,
    flattened) at N_INDEX evenly spread indices."""
    x = np.asarray(x, dtype=float).ravel()
    index = np.unique(np.linspace(0, x.size - 1, N_INDEX).round()
                      .astype(int))
    return {'size': int(x.size), 'norm': float(np.linalg.norm(x)),
            'max_abs': float(np.max(np.abs(x))), 'index': index.tolist(),
            'values': x[index].tolist()}


def pair_key(pair):
    return '|'.join(pair)


def component_key(key):
    """'core', or a metal pair's 'name1|name2'."""
    return key if key == 'core' else pair_key(key)


def sensitivity(vega):
    """Partials and Fisher sums of vega.sensitivity, as JSON: per pair of
    names the sum over the masked bins, distorted and raw, and the sum of
    the bins' absolute values (the sums' scale)."""
    out = {'partials': {}, 'fisher_sums': {}, 'fisher_abs_sums': {}}
    for corr, partials in vega.sensitivity['partials'].items():
        out['partials'][corr] = {name: summary(p)
                                 for name, p in partials.items()}
        fisher = vega.sensitivity['fisher'][corr]
        out['fisher_sums'][corr] = {
            pair_key(pair): np.nansum(f, axis=1).tolist()
            for pair, f in fisher.items()}
        out['fisher_abs_sums'][corr] = {
            pair_key(pair): np.nansum(np.abs(f), axis=1).tolist()
            for pair, f in fisher.items()}
    return out


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

    fit = json.loads(DR16PUB.read_text())
    names = fit['names']
    point = dict(zip(names, fit['fit_dense']['values']))
    nominal = {n: (v, e) for n, v, e in zip(
        names, fit['fit_dense']['values'], fit['fit_dense']['errors'])}
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_dr16_published_dataset(work, size='full',
                                                   components=True)
        seconds['dataset'] = time.perf_counter() - t_start
        vega = VegaInterface(main_ini)
        assert list(vega.sample_params['limits']) == names
        assert vega.fiducial['save-components']

        t0 = time.perf_counter()
        model = vega.compute_model(point, run_init=False)
        seconds['compute_model'] = time.perf_counter() - t0
        components = {}
        for corr, m in vega.models.items():
            components[corr] = {
                f'{prefix}{comp}/{part}/{component_key(key)}':
                    summary(value)
                for prefix, owner in (('', m), ('metals/', m.metals))
                if owner is not None
                for comp in COMPONENTS for part in PARTS
                for key, value in getattr(owner, comp)[part].items()}
            components[corr]['model'] = summary(model[corr])

        t0 = time.perf_counter()
        vega.compute_sensitivity_exact(nominal=nominal, verbose=False)
        seconds['sensitivity_exact'] = time.perf_counter() - t0
        exact = sensitivity(vega)

        # the other sampled names at POINT too, as after a fit there
        vega.params.update(point)
        t0 = time.perf_counter()
        vega.compute_sensitivity(
            nominal={n: nominal[n] for n in FD_NAMES}, verbose=False)
        seconds['sensitivity_fd'] = time.perf_counter() - t0
        fd = sensitivity(vega)
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'config': 'synthetic-dr16-published-full with components: '
                  "make_jax_dr16_published_dataset(work, size='full', "
                  'components=True)',
        'path': 'vega_tpu compute_model / compute_sensitivity_exact / '
                'compute_sensitivity, CPU, f64, VEGA_TPU_FACTORED=0',
        'names': names, 'point': point,
        'nominal': {n: list(v) for n, v in nominal.items()},
        'fd_names': list(FD_NAMES), 'n_index': N_INDEX,
        'components': components, 'exact': exact, 'fd': fd,
        'seconds': seconds,
        'command': 'JAX_PLATFORMS=cpu python '
                   'tests/tools/make_torch_port_run_vega_goldens.py',
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s')


if __name__ == '__main__':
    main()
