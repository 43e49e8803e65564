"""Write tests/data/torch_port_f32_terms_goldens.json: the JAX package's
(vega_tpu) f32 throughput mode (VEGA_TPU_X64=0) on the CPU, on the
configurations whose model terms the port's f32 mode carries since the
mocks and the reference's own terms joined it:

- 'tiny': written by the port's own dataset functions on the CPU
  (vega_tpu_torch.testing, as tests/test_torch_f32_terms.py writes them;
  `make_tiny`) with 8 x 8 (ap, at) grid nodes: synthetic-desi-mock
  (full-shape smoothing beside the new-metals stacks, Rogers HCD and the
  QSO radiation), synthetic-lyacolore (per-row smoothing with sampled
  widths on old_fftlog's legacy grid), synthetic-dr16-uv (UV fluctuations
  and shotnoise, the relativistic and asymmetry pair, Croom) and a
  4-dimension table6 payload (6 x 6 x 4 x 4 nodes through the
  combination schedule); the variants of `VARIANTS`: uv's HeII, split
  evolution, single_multipole and fht_extrap, desi's
  rescale-coords-systematics and the mock options (Gaussian and
  lorentz_gauss velocity dispersions, Pk damping, mock binning,
  mock-los-smoothing). Each: the dense chi^2 at 4 points drawn around
  the configuration's values, the value and gradient at the first, and
  for the four configurations the grid or route chi^2 at the same
  points, in f32 and, from this process, in f64.
- 'full': synthetic-desi-mock-full, synthetic-lyacolore-full and
  synthetic-dr16-uv-full, each written by the JAX side's dataset
  function with the arguments of its f64 goldens tool
  (make_torch_port_{mocks,uv}_goldens.py): the dense chi^2
  (VEGA_TPU_FACTORED=0) in f32 at the 8 points of
  tests/data/torch_port_{mocks,uv}_goldens.json, beside the f64 chi^2
  stored there; uv's single_multipole and fht_extrap variants at the
  variant point and the first 3 golden points, and synthetic-desi-full
  with rescale-coords-systematics on the cross (make_torch_port_desi_
  goldens.py's files and points, the joint covariance), in f32 and f64.
  chip_smoke.py's f32_terms phase holds the port's f32 mode against
  them. vega_tpu cannot sweep table6's 7,737 nodes at full size here:
  table6 has no full record.

The f32 numbers come from a subprocess under VEGA_TPU_X64=0
(make_torch_port_f32_models_goldens.py's F32_SCRIPT and run_job);
VEGA_TPU_DS_MATMUL=0 and no payload cache in both processes. Where
vega_tpu's f32 raises or gives a non-finite chi^2 the record says so.

Usage (from the repo root; about 11 minutes on 8 cores, 13 GB):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_f32_terms_goldens.py
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
OUT = REPO / 'tests' / 'data' / 'torch_port_f32_terms_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

from make_torch_port_f32_models_goldens import (F32_SCRIPT,  # noqa: E402
                                                run_job,
                                                sampled_truth)
from make_torch_port_uv_goldens import VARIANTS as UV_VARIANTS  # noqa: E402

TINY_POINTS = 4
NODES = {'grid-nodes-ap': '8', 'grid-nodes-at': '8', 'ds-matmul': 'False'}
CONTROL = ''.join(f'{k} = {v}\n' for k, v in NODES.items())
TABLE6_CONTROL = ('grid-nodes-ap = 6\ngrid-nodes-at = 6\n'
                  'grid-nodes-drp_QSO = 4\n'
                  'grid-nodes-sigma_velo_disp_lorentz_QSO = 4\n'
                  'grid-combination = always\nds-matmul = False\n')
# the configurations with a grid or route regime, and the spread of their
# points around the configuration's values (uv's chi^2 grows ~1e5 at 1%)
CONFIGS = ('desi_mock', 'lyacolore', 'uv', 'table6')
SPREAD = {'uv': 1e-3}
# the variants: uv's of make_torch_port_uv_goldens.py; the mocks' as
# (dataset_variant's arguments, the line that replaces VELOCITY in the
# cross's [model] or None)
UV_CHANGES = {f'uv_{label}': changes
              for label, changes in UV_VARIANTS.items()}
VELOCITY = 'velocity dispersion = lorentz\n'
MOCK_CHANGES = {
    # tests/tools/variant_configs.py:150 (velo_gauss)
    'mock_velo_gauss': ({'parameters': 'sigma_velo_disp_gauss_QSO = 5.2\n'},
                        'velocity dispersion = gauss\n'),
    # tests/test_torch_mocks.py's 'velocity_lorentz_gauss'
    'mock_lorentz_gauss': ({'parameters':
                            'sigma_velo_disp_gauss_QSO = 3.1\n'},
                           'velocity dispersion = lorentz_gauss\n'),
    # tests/tools/variant_configs.py:391 (pk_damping_nogk)
    'mock_pk_damping': ({'auto': 'pk-damping-scale = 10.0\n'
                                 'pk-damping-power = 4\n'
                                 'model binning = False\n',
                         'cross': 'model binning = False\n'}, None),
    # tests/tools/variant_configs.py:463 (mock_binsize)
    'mock_binning': ({'auto': 'mock-bin-size = 0.4\n'
                              'mock-los-smoothing = growth\n'}, None),
    # tests/test_torch_mocks.py's 'mock_bin_amplitude' and
    # 'mock_bin_only_los'
    'mock_los_smoothing': ({'auto': 'mock-bin-size = 3.2\n'
                                    'mock-los-smoothing = amplitude\n',
                            'cross': 'mock-bin-size = 3.2\n'
                                     'mock-los-smoothing = only-los\n',
                            'parameters': 'los_smooth_amp = 0.4\n'}, None),
}
VARIANTS = (*UV_CHANGES, 'desi_rescale', *MOCK_CHANGES)
RESCALE = {'cross': 'rescale-coords-systematics = True\n'}
FULL_UV_VARIANTS = ('uv_single_multipole', 'uv_fht_extrap')
FULL_VARIANT_ROWS = 3


def mock_variant(main, workdir, label):
    """A copy of the tiny DESI mock's files with the options of
    MOCK_CHANGES[label] (the cross's velocity dispersion replaced)."""
    from vega_tpu_torch.testing import dataset_variant
    changes, velocity = MOCK_CHANGES[label]
    out = dataset_variant(main, workdir, **changes)
    if velocity is not None:
        cross = Path(out).parent / 'qsoxlya.ini'
        cross.write_text(cross.read_text().replace(VELOCITY, velocity, 1))
    return out


def make_tiny(name, workdir, device='cpu', bases=None):
    """(main ini, grid ini or None) of the tiny configuration or variant
    `name` written by the port's dataset functions on `device`; a variant
    copies its base's files (`bases`, {base: main ini}, written when
    absent)."""
    from make_torch_port_f32_models_goldens import make_tiny as models_tiny
    from vega_tpu_torch.testing import (DESI_MOCK_FIT_SAMPLE,
                                        DESI_MOCK_GRID_NAMES, DR16_METALS,
                                        LYACOLORE_FIT_SAMPLE, TABLE6_SAMPLE,
                                        dataset_variant, dr16_extra_model,
                                        make_desi_mock_dataset,
                                        make_dr16_uv_dataset,
                                        make_lyacolore_dataset,
                                        make_synthetic_dataset, with_sample)
    workdir = Path(workdir)
    bases = {} if bases is None else bases
    base = ('uv' if name.startswith('uv_') else 'desi_mock'
            if name.startswith('mock_') else 'desi'
            if name == 'desi_rescale' else None)
    if base is not None:
        if base not in bases:
            bases[base] = make_tiny(base, workdir.parent / base, device,
                                    bases)[0]
        if base == 'uv':
            return dataset_variant(bases[base], workdir,
                                   **UV_CHANGES[name]), None
        if base == 'desi':
            return dataset_variant(bases[base], workdir, **RESCALE), None
        return mock_variant(bases[base], workdir, name), None
    if name == 'desi':
        return models_tiny('desi', workdir, device)[0], None
    if name == 'desi_mock':
        main = Path(make_desi_mock_dataset(
            workdir, size='tiny', device=device, sample=DESI_MOCK_FIT_SAMPLE,
            extra_control=CONTROL))
        return main, Path(with_sample(
            main, {n: DESI_MOCK_FIT_SAMPLE[n] for n in DESI_MOCK_GRID_NAMES},
            workdir / 'main_grid.ini'))
    if name == 'lyacolore':
        main = Path(make_lyacolore_dataset(
            workdir, size='tiny', device=device, sample=LYACOLORE_FIT_SAMPLE,
            extra_control=NODES))
        return main, main
    if name == 'uv':
        main = Path(make_dr16_uv_dataset(workdir, size='tiny', device=device,
                                         extra_control=CONTROL))
        return main, main
    if name == 'table6':
        main = Path(make_synthetic_dataset(
            workdir, cross=True, size='tiny', device=device,
            sample=TABLE6_SAMPLE, metals=list(DR16_METALS),
            extra_model=dr16_extra_model(), extra_control=TABLE6_CONTROL))
        return main, main
    raise KeyError(name)


def tiny_points(name, main):
    """The dense rows of `name`: TINY_POINTS drawn around its values
    (SPREAD of them, 1% by default; seed 0)."""
    import numpy as np
    truth = sampled_truth(main)
    spread = SPREAD.get(name.split('_')[0], 1e-2)
    rng = np.random.default_rng(0)
    return {n: (v + spread * (abs(v) or 0.1)
                * rng.normal(size=TINY_POINTS)).tolist()
            for n, v in truth.items()}


def tiny_jobs(work):
    """The tiny configurations' and variants' jobs, keyed
    '<name>/<regime>'."""
    from vega_tpu_torch.testing import DESI_MOCK_GRID_NAMES
    jobs, bases = {}, {}
    for name in (*CONFIGS, *VARIANTS):
        main, grid_main = make_tiny(name, Path(work) / name, bases=bases)
        if name in CONFIGS:
            bases[name] = main
        points = tiny_points(name, main)
        point = {n: v[0] for n, v in points.items()}
        jobs[f'{name}/dense'] = {'main': str(main), 'regime': 'dense',
                                 'points': points, 'point': point}
        if grid_main is not None:
            grid_names = (DESI_MOCK_GRID_NAMES if name == 'desi_mock'
                          else list(points))
            jobs[f'{name}/grid'] = {
                'main': str(grid_main), 'regime': 'grid',
                'points': {n: points[n] for n in grid_names}}
    return jobs


def full_jobs(work):
    """The full configurations' dense jobs at their f64 goldens' points,
    and the card variants', on files written by the JAX side's dataset
    functions with the f64 tools' arguments."""
    from jax_metal_dataset import make_jax_metal_dataset
    from jax_mocks_dataset import (make_jax_desi_mock_dataset,
                                   make_jax_lyacolore_dataset)
    from make_torch_port_desi_goldens import SAMPLE as DESI_SAMPLE
    from make_torch_port_desi_goldens import extra_control
    from vega_tpu_torch.testing import (DESI_METALS, DESI_MOCK_FIT_SAMPLE,
                                        DR16_METALS, LYACOLORE_FIT_SAMPLE,
                                        dataset_variant, desi_extra_model,
                                        dr16_uv_extra_model)
    data = REPO / 'tests' / 'data'
    mocks = json.loads((data / 'torch_port_mocks_goldens.json').read_text())
    uv = json.loads((data / 'torch_port_uv_goldens.json').read_text())
    desi = json.loads((data / 'torch_port_desi_goldens.json').read_text())
    work = Path(work)
    os.environ['VEGA_TPU_FACTORED'] = '0'   # lyacolore's data: the dense
    try:
        mains = {
            'desi_mock': make_jax_desi_mock_dataset(
                work / 'desi_mock', size='full', sample=DESI_MOCK_FIT_SAMPLE),
            'lyacolore': make_jax_lyacolore_dataset(
                work / 'lyacolore', size='full', sample=LYACOLORE_FIT_SAMPLE),
            'uv': make_jax_metal_dataset(
                work / 'uv', list(DR16_METALS), cross=True, size='full',
                sample=uv['sample'], extra_model=dr16_uv_extra_model(),
                qso_z_evol='croom'),
            'desi': make_jax_metal_dataset(
                work / 'desi', list(DESI_METALS), cross=True, size='full',
                sample=DESI_SAMPLE, extra_model=desi_extra_model(),
                new_metals=True, global_cov=True,
                extra_control=extra_control())}
    finally:
        os.environ.pop('VEGA_TPU_FACTORED', None)
    jobs = {name: {'main': str(mains[name]), 'regime': 'dense',
                   'points': mocks[name]['params']}
            for name in ('desi_mock', 'lyacolore')}
    jobs['uv'] = {'main': str(mains['uv']), 'regime': 'dense',
                  'points': uv['params']}
    rows = {n: [uv['variant_point'][n]] + uv['params'][n][:FULL_VARIANT_ROWS]
            for n in uv['variant_point']}
    for label in FULL_UV_VARIANTS:
        jobs[label] = {'main': str(dataset_variant(
            mains['uv'], work / label, **UV_CHANGES[label])),
            'regime': 'dense', 'points': rows}
    jobs['desi_rescale'] = {'main': str(dataset_variant(
        mains['desi'], work / 'desi_rescale', **RESCALE)),
        'regime': 'dense', 'points': desi['params']}
    return jobs


def f32_subprocess(jobs, job_file, env):
    """vega_tpu's f32 numbers of `jobs` from a process under
    VEGA_TPU_X64=0."""
    job_file.write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, '-c', F32_SCRIPT, str(job_file),
         str(Path(__file__).resolve().parent)],
        capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, record in out.items():
        if 'error' not in record and record['dtype'] != 'float32':
            raise SystemExit(f'{key} ran in {record["dtype"]}')
    return out


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
    data = REPO / 'tests' / 'data'
    f64_full = {
        'desi_mock': json.loads((data / 'torch_port_mocks_goldens.json')
                                .read_text())['desi_mock']['chi2_dense'],
        'lyacolore': json.loads((data / 'torch_port_mocks_goldens.json')
                                .read_text())['lyacolore']['chi2_dense'],
        'uv': json.loads((data / 'torch_port_uv_goldens.json')
                         .read_text())['chi2_dense']}
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
        t0 = time.perf_counter()
        for label in (*FULL_UV_VARIANTS, 'desi_rescale'):
            f64[f'full/{label}'] = run_job(jobs['full'][label])
        seconds['full_f64'] = time.perf_counter() - t0
        out32 = {}
        for size in ('tiny', 'full'):
            t0 = time.perf_counter()
            out32[size] = f32_subprocess(jobs[size],
                                         work / f'jobs_{size}.json', env)
            seconds[f'{size}_f32'] = time.perf_counter() - t0
    for size, records in out32.items():
        for key, record in records.items():
            print(f'{size} {key}: {record}')
    tiny = {}
    for key, job in jobs['tiny'].items():
        tiny[key] = {'points': job['points'], 'f32': out32['tiny'][key],
                     'f64': f64[key]}
        if 'point' in job:
            tiny[key]['point'] = job['point']
    full = {}
    for name, job in jobs['full'].items():
        record = out32['full'][name]
        want = (f64_full[name] if name in f64_full
                else f64[f'full/{name}']['chi2'])
        full[name] = {'points': job['points'], 'f32': record,
                      'chi2_dense_f64': want}
        if 'chi2' in record:
            full[name]['max_abs_f32_minus_f64'] = float(np.max(np.abs(
                np.asarray(record['chi2']) - np.asarray(want))))
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'path': 'vega_tpu under VEGA_TPU_X64=0 (f32) and x64 (f64), CPU, '
                'VEGA_TPU_DS_MATMUL=0',
        'full_configs': {
            'desi_mock': 'make_torch_port_mocks_goldens.py\'s files',
            'lyacolore': 'make_torch_port_mocks_goldens.py\'s files',
            'uv': 'make_torch_port_uv_goldens.py\'s files',
            'uv_single_multipole, uv_fht_extrap': 'dataset_variant of uv\'s '
                                                  'files, UV_CHANGES',
            'desi_rescale': 'dataset_variant of '
                            'make_torch_port_desi_goldens.py\'s files with '
                            'rescale-coords-systematics on the cross'},
        'tiny_configs': 'make_tiny(): the port\'s dataset functions at '
                        "size='tiny' on the CPU",
        'made_by': 'tests/tools/make_torch_port_f32_terms_goldens.py',
        'full': full, 'tiny': tiny,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}')


if __name__ == '__main__':
    main()
