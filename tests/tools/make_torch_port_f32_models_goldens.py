"""Write tests/data/torch_port_f32_models_goldens.json: the JAX package's
(vega_tpu) f32 throughput mode (VEGA_TPU_X64=0) on the CPU, on the eBOSS
DR16 and DESI configurations:

- 'full': synthetic-dr16-full, synthetic-desi-full and
  synthetic-dr16-published-full, each written by the JAX side's dataset
  function with the arguments of its f64 goldens tool
  (make_torch_port_{dr16,desi,dr16pub}_goldens.py): the dense chi^2
  (VEGA_TPU_FACTORED=0; DESI under its joint covariance) at the 8 points
  of tests/data/torch_port_{dr16,desi,dr16pub}_goldens.json, beside the
  f64 chi^2 stored there. chip_smoke.py's f32_models phase holds the
  port's f32 mode against both.
- 'tiny': the same three configurations at size='tiny', written by the
  port's own dataset functions on the CPU (vega_tpu_torch.testing, as
  tests/test_torch_f32_models.py writes them; `make_tiny`), with 8 x 8
  (ap, at) grid nodes: the dense chi^2 at 4 points drawn 1% around the
  configuration's values, the value and gradient at the first of them,
  and the grid-collapse chi^2 at the same points (dr16: its 8 names;
  desi: the 14 grid names of its per-correlation covariance file
  main_grid.ini; dr16pub: vega_tpu's route for its 18 names, the crosses
  from a 8 x 8 x 3 x 3 payload over (ap, at, drp_QSO,
  sigma_velo_disp_lorentz_QSO), the autos dense), and dr16pub's route
  with the default nodes (32 x 32 x 12 x 12, the full configuration's
  spec; `make_tiny_route`), in f32 and, from this process, in f64.

The f32 numbers come from a subprocess under VEGA_TPU_X64=0, as
tests/test_f32_mode.py runs the f32 mode (the x64 switch is read when
vega_tpu is imported); VEGA_TPU_DS_MATMUL=0 and no payload cache in both
processes. Where vega_tpu's f32 raises or gives a non-finite chi^2 the
record says so ('error' / the values as they are).

Usage (from the repo root; about 5 minutes on 8 cores, 2.5 GB):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_f32_models_goldens.py
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
OUT = REPO / 'tests' / 'data' / 'torch_port_f32_models_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

CONFIGS = ('dr16', 'desi', 'dr16pub')
F64_GOLDENS = {name: REPO / 'tests' / 'data'
               / f'torch_port_{name}_goldens.json' for name in CONFIGS}
TINY_POINTS = 4
TINY_NODES = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
DR16PUB_NODES = {'grid-nodes-ap': '8', 'grid-nodes-at': '8',
                 'grid-nodes-drp_QSO': '3',
                 'grid-nodes-sigma_velo_disp_lorentz_QSO': '3',
                 'ds-matmul': 'False'}

F32_SCRIPT = r"""
import json, os, sys
os.environ['VEGA_TPU_X64'] = '0'
os.environ['VEGA_TPU_DS_MATMUL'] = '0'
os.environ['VEGA_TPU_GRID_CACHE'] = '0'
os.environ.pop('VEGA_TPU_FACTORED', None)
os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', False)
sys.path.insert(0, sys.argv[2])
from make_torch_port_f32_models_goldens import run_job

jobs = json.loads(open(sys.argv[1]).read())
print(json.dumps({key: run_job(job) for key, job in jobs.items()}))
"""


def run_job(job):
    """vega_tpu's numbers for one job ({'main', 'regime' ('dense' or
    'grid'), 'points', optional 'point'}) in this process's dtype:
    {'dtype', 'chi2' [, 'value', 'gradient']}, or {'error': type and
    message} where vega_tpu raises."""
    import numpy as np
    from vega_tpu.vega_interface import VegaInterface
    if job['regime'] == 'dense':
        # vega_tpu reads VEGA_TPU_FACTORED when it traces a call
        os.environ['VEGA_TPU_FACTORED'] = '0'
    else:
        os.environ.pop('VEGA_TPU_FACTORED', None)
    try:
        vega = VegaInterface(job['main'])
        chi2 = np.asarray(vega.chi2_batch(
            {k: np.asarray(v) for k, v in job['points'].items()}))
        out = {'dtype': str(chi2.dtype), 'chi2': [float(c) for c in chi2]}
        if 'point' in job:
            value, grad = vega.chi2_value_and_gradient(job['point'])
            out['value'] = float(value)
            out['gradient'] = {n: float(g) for n, g in grad.items()}
    except Exception as exc:        # recorded: the port must raise alike
        out = {'error': f'{type(exc).__name__}: {exc}'}
    finally:
        os.environ.pop('VEGA_TPU_FACTORED', None)
    return out


def make_tiny(name, workdir, device='cpu'):
    """main.ini of the tiny configuration `name` written by the port's
    dataset functions on `device`, and the ini its grid regime reads (desi:
    main_grid.ini, the same files without the joint covariance; else the
    same ini)."""
    from make_torch_port_desi_goldens import SAMPLE as DESI_SAMPLE
    from make_torch_port_desi_goldens import grid_ini
    from make_torch_port_dr16_goldens import SAMPLE as DR16_SAMPLE
    from vega_tpu_torch.testing import (DESI_METALS, DESI_PRIORS,
                                        DR16_METALS, desi_extra_model,
                                        dr16_extra_model,
                                        make_dr16_published_dataset,
                                        make_synthetic_dataset,
                                        priors_section)
    if name == 'dr16pub':
        main = Path(make_dr16_published_dataset(
            workdir, size='tiny', device=device, extra_control=DR16PUB_NODES))
        return main, main
    if name == 'dr16':
        main = Path(make_synthetic_dataset(
            workdir, cross=True, size='tiny', device=device,
            sample=DR16_SAMPLE, metals=list(DR16_METALS),
            extra_model=dr16_extra_model(), extra_control=TINY_NODES))
        return main, main
    main = Path(make_synthetic_dataset(
        workdir, cross=True, size='tiny', device=device, sample=DESI_SAMPLE,
        metals=list(DESI_METALS), extra_model=desi_extra_model(),
        new_metals=True, global_cov=True,
        extra_control=TINY_NODES + priors_section(DESI_PRIORS)))
    return main, grid_ini(main)


def make_tiny_route(workdir, device='cpu'):
    """main.ini of tiny synthetic-dr16-published with the default grid
    nodes (32 x 32 x 12 x 12 over ap, at, drp_QSO and
    sigma_velo_disp_lorentz_QSO, the full configuration's payload
    spec), written by the port's dataset function on `device`."""
    from vega_tpu_torch.testing import make_dr16_published_dataset
    return Path(make_dr16_published_dataset(
        workdir, size='tiny', device=device,
        extra_control={'ds-matmul': 'False'}))


def sampled_truth(main):
    """{name: value} of the main ini's sampled names, at the values the
    configuration was written with (the [parameters] of the main and
    correlation inis)."""
    import configparser

    def parser(path):
        config = configparser.ConfigParser()
        config.optionxform = lambda option: option
        config.read(path)
        return config

    config = parser(main)
    values = {}
    for path in config['data sets']['ini files'].split():
        corr = parser(path)
        if 'parameters' in corr:
            values.update({k: float(v) for k, v in corr['parameters'].items()
                           if not k.startswith(('par binsize',
                                                'per binsize'))})
    values.update({k: float(v) for k, v in config['parameters'].items()})
    return {name: values[name] for name in config['sample']}


def draw(truth, n_rows, seed=0):
    """Rows 1% around `truth` (0.001 around a zero value)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {n: (v + 0.01 * (abs(v) or 0.1) * rng.normal(size=n_rows)).tolist()
            for n, v in truth.items()}


def tiny_jobs(work):
    """The tiny configurations' jobs, keyed '<config>/<regime>'."""
    from make_torch_port_desi_goldens import GRID_NAMES
    jobs = {}
    for name in CONFIGS:
        main, grid_main = make_tiny(name, Path(work) / name)
        points = draw(sampled_truth(main), TINY_POINTS)
        point = {n: v[0] for n, v in points.items()}
        jobs[f'{name}/dense'] = {'main': str(main), 'regime': 'dense',
                                 'points': points, 'point': point}
        grid_names = GRID_NAMES if name == 'desi' else list(points)
        jobs[f'{name}/grid'] = {
            'main': str(grid_main), 'regime': 'grid',
            'points': {n: points[n] for n in grid_names}}
    jobs['dr16pub/route_default_nodes'] = {
        'main': str(make_tiny_route(Path(work) / 'dr16pub_route')),
        'regime': 'grid', 'points': jobs['dr16pub/dense']['points']}
    return jobs


def full_jobs(work):
    """The full configurations' dense jobs at their f64 goldens' points,
    on files written by the JAX side's dataset functions with the f64 tools'
    arguments."""
    from jax_dr16pub_dataset import make_jax_dr16_published_dataset
    from jax_metal_dataset import make_jax_metal_dataset
    from make_torch_port_desi_goldens import SAMPLE as DESI_SAMPLE
    from make_torch_port_desi_goldens import extra_control
    from make_torch_port_dr16_goldens import SAMPLE as DR16_SAMPLE
    from vega_tpu_torch.testing import (DESI_METALS, DR16_METALS,
                                        desi_extra_model, dr16_extra_model)
    mains = {
        'dr16': make_jax_metal_dataset(
            Path(work) / 'dr16', list(DR16_METALS), cross=True, size='full',
            sample=DR16_SAMPLE, extra_model=dr16_extra_model()),
        'desi': make_jax_metal_dataset(
            Path(work) / 'desi', list(DESI_METALS), cross=True,
            size='full', sample=DESI_SAMPLE, extra_model=desi_extra_model(),
            new_metals=True, global_cov=True, extra_control=extra_control()),
        'dr16pub': make_jax_dr16_published_dataset(Path(work) / 'dr16pub',
                                                   size='full')}
    jobs = {}
    for name in CONFIGS:
        golden = json.loads(F64_GOLDENS[name].read_text())
        jobs[name] = {'main': str(mains[name]), 'regime': 'dense',
                      'points': golden.get('params', golden.get('points'))}
    return jobs


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ.pop('VEGA_TPU_FACTORED', None)
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import numpy as np

    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        t0 = time.perf_counter()
        jobs = {'tiny': tiny_jobs(work / 'tiny'),
                'full': full_jobs(work / 'full')}
        seconds['datasets'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f64 = {key: run_job(job) for key, job in jobs['tiny'].items()}
        seconds['tiny_f64'] = time.perf_counter() - t0
        out32 = {}
        for size in ('tiny', 'full'):
            job_file = work / f'jobs_{size}.json'
            job_file.write_text(json.dumps(jobs[size]))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, '-c', F32_SCRIPT, str(job_file),
                 str(Path(__file__).resolve().parent)],
                capture_output=True, text=True, env=env)
            seconds[f'{size}_f32'] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(proc.stderr[-4000:])
            out32[size] = json.loads(proc.stdout.strip().splitlines()[-1])
    for size, records in out32.items():
        for key, record in records.items():
            if 'error' not in record and record['dtype'] != 'float32':
                raise SystemExit(f'{size} {key} ran in {record["dtype"]}')
            print(f'{size} {key}: {record}')
    tiny = {}
    for key, job in jobs['tiny'].items():
        tiny[key] = {'points': job['points'], 'f32': out32['tiny'][key],
                     'f64': f64[key]}
        if 'point' in job:
            tiny[key]['point'] = job['point']
    full = {}
    for name, job in jobs['full'].items():
        golden = json.loads(F64_GOLDENS[name].read_text())
        record = out32['full'][name]
        full[name] = {'points': job['points'], 'f32': record,
                      'chi2_dense_f64': golden['chi2_dense']}
        if 'chi2' in record:
            d = np.abs(np.asarray(record['chi2'])
                       - np.asarray(golden['chi2_dense']))
            full[name]['max_abs_f32_minus_f64'] = float(d.max())
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'path': 'vega_tpu under VEGA_TPU_X64=0 (f32) and, for the tiny '
                'records, x64 (f64), CPU, VEGA_TPU_DS_MATMUL=0',
        'full_configs': {
            'dr16': 'make_torch_port_dr16_goldens.py\'s files',
            'desi': 'make_torch_port_desi_goldens.py\'s files (joint '
                    'covariance)',
            'dr16pub': 'make_torch_port_dr16pub_goldens.py\'s files'},
        'tiny_configs': 'make_tiny(): the port\'s dataset functions at '
                        "size='tiny' on the CPU with 8 x 8 grid nodes "
                        '(dr16pub: 8 x 8 x 3 x 3)',
        'made_by': 'tests/tools/make_torch_port_f32_models_goldens.py',
        'full': full, 'tiny': tiny,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}')


if __name__ == '__main__':
    main()
