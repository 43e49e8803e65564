"""Write tests/data/torch_port_f32_options_goldens.json: the JAX package's
(vega_tpu) f32 throughput mode (VEGA_TPU_X64=0) on the CPU, on the
likelihood options the port's f32 mode carries since it took them over
(save-components, small-scale marginalization in the covariance and in
the fit, model_pk, use_full_pk_for_mc, correlations without a data
file), beside vega_tpu's f64 on the same files:

- 'tiny': written by the port's own dataset functions on the CPU
  (`make_tiny`, as tests/test_torch_f32_options.py writes them):
  - 'marg' / 'marg_in_fit': synthetic-desi-marg at size='tiny' (the DESI
    model of synthetic-desi with new-metals matrices, a distortion
    matrix, noise 1, DESI_MARG_SAMPLE's five names, 8 x 8 (ap, at) grid
    nodes; BuildConfig's marginalization, MARG_MODEL, added to both
    [model]s with the r-min cut at ALL_RMIN_CUT, since at size='tiny' no
    bin lies below the default cut), the second with [control]
    marginalize-in-fit = True: the dense chi^2 at 4 points drawn around
    the configuration's values, the value and gradient at the first,
    chi2(return_marg_coeff=True) and compute_marg_coeff of the model
    there, corr_num_marg_modes and log_lik(return_marg_coeff=True) at
    DERIVED_ROWS rows (the samplers' derived columns), and for 'marg' the
    grid route's chi^2 at the same points;
  - 'components_fit': tests/test_scripts.py's tiny auto (written by the
    port's make_synthetic_dataset, noise 1) with [output] write_pk /
    write_cf,
    through run_vega (the port's `cli fit`): the best fit and every
    column of PK_lyaxlya and Xi_lyaxlya, with its dtype;
  - 'components': synthetic-dr16-published at size='tiny' with the
    components written (make_dr16_published_dataset(..., components=
    True)): compute_model at the configuration's values, every saved
    component (the metal pairs' among them) summarised;
  - 'model_pk', 'direct', 'data_free': the mc phase's configuration at
    size='tiny' (the mc goldens' sample and [monte carlo] sections):
    compute_model's multipoles under model_pk; under use_full_pk_for_mc
    with an empty [sample] the fiducial of get_fiducial_for_monte_carlo
    and MonteCarloEngine.fit_mocks on one numpy mock around it, then
    initialize_monte_carlo's mock (Analysis.create_monte_carlo_sim); with
    has_datafile = False the exception type of each evaluation.
- 'full': the card's files, written by the JAX side's dataset functions
  with the arguments of the f64 goldens tools, f32 only (the f64 numbers
  are in the f64 goldens files) except where noted:
  - 'marg' / 'marg_in_fit': synthetic-desi-marg-full
    (make_torch_port_marg_goldens.py): the dense chi^2 at its 8 points;
    for 'marg_in_fit' also the value and gradient at the JAX f64 best
    fit of marginalize-in-fit and at its first derivative point, and the
    coefficients at the best fit, in f32 and f64;
  - 'components': synthetic-dr16-published-full with the components
    (make_torch_port_run_vega_goldens.py): compute_model at its point,
    every saved component summarised (its `summary`);
  - 'model_pk', 'direct', 'data_free': the mc phase's files
    (make_torch_port_options_goldens.py): the multipoles, the
    use_full_pk_for_mc fiducial and the data-free exception types.

The f32 numbers come from a subprocess under VEGA_TPU_X64=0 (the x64
switch is read when vega_tpu is imported), as
make_torch_port_f32_models_goldens.py runs them; VEGA_TPU_DS_MATMUL=0 and
no payload cache in both processes; the pair histograms on one OpenMP
thread. Where vega_tpu raises, the record says so ('error').

Usage (from the repo root; about 12 minutes on 8 cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_f32_options_goldens.py
"""

from __future__ import annotations

import os

os.environ['OMP_NUM_THREADS'] = '1'

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_f32_options_goldens.json'
MARG_GOLDENS = REPO / 'tests' / 'data' / 'torch_port_marg_goldens.json'
MC_GOLDENS = REPO / 'tests' / 'data' / 'torch_port_mc_goldens.json'
RUN_VEGA_GOLDENS = REPO / 'tests' / 'data' / 'torch_port_run_vega_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

TINY_POINTS = 4
DERIVED_ROWS = 3
TINY_CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
# all-rmin marginalizes the bins the r-min cut leaves out: at size='tiny'
# (20 Mpc/h bins) the default cut of 10 leaves none out
ALL_RMIN_CUT = 40.
MOCK_SEED = 20261018
DIRECT_MOCK_NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
DATA_FREE_CALLS = ('compute_model', 'compute_model_no_init', 'chi2',
                   'chi2_batch')
COMPONENTS = ('pk', 'xi', 'xi_distorted')
PARTS = ('peak', 'smooth', 'full')

F32_SCRIPT = r"""
import json, os, sys
os.environ['VEGA_TPU_X64'] = '0'
os.environ['VEGA_TPU_DS_MATMUL'] = '0'
os.environ['VEGA_TPU_GRID_CACHE'] = '0'
os.environ['MPLBACKEND'] = 'Agg'
os.environ.pop('VEGA_TPU_FACTORED', None)
os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', False)
sys.path.insert(0, sys.argv[2])
from make_torch_port_f32_options_goldens import run_job

jobs = json.loads(open(sys.argv[1]).read())
print(json.dumps({key: run_job(job) for key, job in jobs.items()}))
"""


def floats(x):
    import numpy as np
    return np.asarray(x, dtype=float).ravel().tolist()


def summary(x):
    """The run_vega goldens' summary of a vector (size, norm, max|x| and
    the values at 64 fixed indices), with its dtype."""
    import numpy as np
    from make_torch_port_run_vega_goldens import summary as summarise
    return {**summarise(x), 'dtype': str(np.asarray(x).dtype)}


def component_key(key):
    return key if key == 'core' else '|'.join(key)


def saved_components(vega):
    """{corr: {'<metals/>comp/part/key': array}} of every saved component
    (the run_vega goldens' keys)."""
    out = {}
    for corr, m in vega.models.items():
        out[corr] = {
            f'{prefix}{comp}/{part}/{component_key(key)}': value
            for prefix, owner in (('', m), ('metals/', m.metals))
            if owner is not None
            for comp in COMPONENTS for part in PARTS
            for key, value in getattr(owner, comp)[part].items()}
    return out


def coefficients(coeffs):
    import numpy as np
    return {n: {'dtype': str(np.asarray(v).dtype), 'values': floats(v)}
            for n, v in coeffs.items()}


def chi2_job(vega, job):
    """The chi^2-side numbers of a marginalization job."""
    import numpy as np
    out = {}
    if 'points' in job:
        chi2 = np.asarray(vega.chi2_batch(
            {k: np.asarray(v) for k, v in job['points'].items()}))
        out.update(dtype=str(chi2.dtype), chi2=floats(chi2))
    for label, point in job.get('derivative_points', {}).items():
        value, grad = vega.chi2_value_and_gradient(point)
        out[f'value/{label}'] = float(value)
        out[f'gradient/{label}'] = {n: float(g) for n, g in grad.items()}
    if 'coeff_point' in job:
        chi2, coeffs = vega.chi2(job['coeff_point'], return_marg_coeff=True)
        out['coeff_chi2'] = float(chi2)
        out['coeff'] = coefficients(coeffs)
        out['compute_marg_coeff'] = coefficients(vega.compute_marg_coeff(
            vega.compute_model(job['coeff_point'], run_init=False)))
    if 'derived_rows' in job:
        out['corr_num_marg_modes'] = {
            n: int(m) for n, m in vega.corr_num_marg_modes.items()}
        out['derived'] = []
        for row in job['derived_rows']:
            log_lik, marg = vega.log_lik(row, return_marg_coeff=True)
            out['derived'].append({'log_lik': float(log_lik),
                                   'dtype': str(np.asarray(marg).dtype),
                                   'marg_coeff': floats(marg)})
    return out


def fit_file_job(job):
    """run_vega on `main`: the best fit and the PK_ / Xi_ columns of its
    results file with their dtypes."""
    from vega_tpu.io.fits import read_fits
    from vega_tpu.scripts.run_vega import run_vega
    import numpy as np
    run_vega(job['main'])
    hdus = {h.name: h for h in read_fits(job['fits'])
            if getattr(h, 'name', '')}
    out = {'hdus': sorted(hdus),
           'bestfit': {str(n): float(v) for n, v in zip(
               hdus['BESTFIT']['names'], hdus['BESTFIT']['values'])}}
    for name, hdu in hdus.items():
        if name.startswith(('PK_', 'Xi_')):
            out[name] = {col: {'dtype': str(np.asarray(hdu[col]).dtype),
                               'values': floats(hdu[col])}
                         for col in hdu.columns}
    return out


def data_free_job(vega):
    import numpy as np
    calls = {
        'compute_model': lambda: vega.compute_model({'bias_LYA': -0.11}),
        'compute_model_no_init': lambda: vega.compute_model(
            {'bias_LYA': -0.11}, run_init=False),
        'chi2': lambda: vega.chi2({'bias_LYA': -0.11}),
        'chi2_batch': lambda: vega.chi2_batch(
            {'bias_LYA': np.array([-0.11, -0.12])}),
    }
    raises = {}
    for call in DATA_FREE_CALLS:
        try:
            calls[call]()
        except Exception as exc:        # recorded: the port must raise alike
            raises[call] = type(exc).__name__
        else:
            raises[call] = None
    return {'raises': raises}


def direct_job(vega, job):
    """use_full_pk_for_mc: the fiducial, and the mock fits when asked."""
    import numpy as np
    fiducial = vega.get_fiducial_for_monte_carlo()
    out = {'fiducial': {n: {'dtype': str(np.asarray(f).dtype),
                            **(summary(f) if job.get('summary')
                               else {'values': floats(f)})}
                        for n, f in fiducial.items()}}
    if job.get('n_mocks'):
        from make_torch_port_mc_goldens import numpy_mocks, sample_subset
        from vega_tpu.parallel import MonteCarloEngine
        mocks = numpy_mocks(vega, fiducial, job['n_mocks'], MOCK_SEED)
        fits = MonteCarloEngine(vega).fit_mocks(
            mocks, sample_subset(vega.mc_config['sample'],
                                 DIRECT_MOCK_NAMES))
        out['mocks'] = {'seed': MOCK_SEED, 'n_mocks': job['n_mocks'],
                        'names': list(fits['names']),
                        **{key: np.asarray(fits[key]).tolist()
                           for key in ('values', 'errors', 'chisq',
                                       'valid')}}
        # Analysis.create_monte_carlo_sim's mock around the fiducial,
        # seeded by [control] mc_seed
        sim = vega.initialize_monte_carlo(print_func=lambda *a: None)
        out['mc_sim'] = {n: {'dtype': str(np.asarray(m).dtype),
                             'values': floats(m)} for n, m in sim.items()}
    return out


def run_job(job):
    """vega_tpu's numbers for one job in this process's dtype ({'kind',
    'main', ...}), or {'error': type and message} where vega_tpu
    raises."""
    import numpy as np
    from vega_tpu.vega_interface import VegaInterface
    if job.get('regime') == 'dense':
        # vega_tpu reads VEGA_TPU_FACTORED when it traces a call
        os.environ['VEGA_TPU_FACTORED'] = '0'
    else:
        os.environ.pop('VEGA_TPU_FACTORED', None)
    try:
        if job['kind'] == 'fit_file':
            return fit_file_job(job)
        vega = VegaInterface(job['main'])
        if job['kind'] == 'chi2':
            return chi2_job(vega, job)
        if job['kind'] == 'components':
            model = vega.compute_model(job['point'], run_init=False)
            out = {'model': {n: summary(m) for n, m in model.items()}}
            out['components'] = {
                corr: {key: summary(value) for key, value in parts.items()}
                for corr, parts in saved_components(vega).items()}
            return out
        if job['kind'] == 'model_pk':
            model = vega.compute_model(run_init=False)
            return {'multipoles': {n: {'dtype': str(np.asarray(m).dtype),
                                       'shape': list(np.shape(m)),
                                       'values': floats(m)}
                                   for n, m in model.items()}}
        if job['kind'] == 'direct':
            return direct_job(vega, job)
        if job['kind'] == 'data_free':
            return data_free_job(vega)
        raise ValueError(job['kind'])
    except Exception as exc:        # recorded: the port must raise alike
        return {'error': f'{type(exc).__name__}: {exc}'}
    finally:
        os.environ.pop('VEGA_TPU_FACTORED', None)


# ----------------------------------------------------------------------
# The files
# ----------------------------------------------------------------------
def with_rmin_cut(ini, cut=ALL_RMIN_CUT):
    """The r-min cut of the tiny correlation ini `ini` (10) set to `cut`,
    in place."""
    text = Path(ini).read_text()
    assert 'r-min = 10.' in text
    Path(ini).write_text(text.replace('r-min = 10.', f'r-min = {cut}', 1))


def with_marg_model(main, all_rmin_cut=None):
    """MARG_MODEL's lines at the top of each correlation's [model] of
    `main` (in place), with the r-min cut at `all_rmin_cut` when given."""
    from vega_tpu_torch.testing import MARG_MODEL
    lines = ''.join(f'{k} = {v}\n' for k, v in MARG_MODEL.items())
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        path = Path(main).parent / ini
        path.write_text(path.read_text().replace(
            '[model]\n', f'[model]\n{lines}', 1))
        if all_rmin_cut is not None:
            with_rmin_cut(path, all_rmin_cut)
    return Path(main)


def make_tiny(name, workdir, device='cpu'):
    """main.ini of the tiny configuration `name` (module docstring),
    written by the port's dataset functions on `device`; 'marg_in_fit' and
    'direct' / 'model_pk' / 'data_free' take their base files from
    `workdir`'s sibling 'marg' / 'mc' when it is there."""
    from make_torch_port_options_goldens import with_lines
    from vega_tpu_torch.testing import (DESI_MARG_SAMPLE, DESI_METALS,
                                        desi_extra_model,
                                        make_dr16_published_dataset,
                                        make_synthetic_dataset,
                                        with_control)
    workdir = Path(workdir)
    if name in ('marg', 'marg_in_fit'):
        base = workdir.parent / 'marg' / 'main.ini'
        if not base.exists():
            base = with_marg_model(make_synthetic_dataset(
                workdir.parent / 'marg', cross=True, size='tiny',
                device=device, sample=DESI_MARG_SAMPLE,
                extra_model=desi_extra_model(), metals=list(DESI_METALS),
                new_metals=True, with_distortion=True, noise=1.0,
                extra_control=TINY_CONTROL), ALL_RMIN_CUT)
        if name == 'marg':
            return base
        return with_control(base, 'marginalize-in-fit = True',
                            base.parent / 'main_in_fit.ini')
    if name == 'components':
        return Path(make_dr16_published_dataset(
            workdir, size='tiny', device=device, components=True,
            extra_control={'ds-matmul': 'False'}))
    if name == 'components_fit':
        main = Path(make_synthetic_dataset(workdir, cross=False,
                                           size='tiny', noise=1.0,
                                           device=device))
        return with_output(main, workdir / 'results')
    mc = json.loads(MC_GOLDENS.read_text())
    base = workdir.parent / 'mc' / 'main.ini'
    if not base.exists():
        base = Path(make_synthetic_dataset(
            workdir.parent / 'mc', cross=True, size='tiny', device=device,
            sample=mc['sample'], extra_control=mc['mc_control']))
    workdir.mkdir(parents=True, exist_ok=True)
    if name == 'direct':
        return with_lines(base, workdir, 'main.ini',
                          control='use_full_pk_for_mc = True', sample={})
    if name == 'model_pk':
        return with_lines(base, workdir, 'main.ini',
                          control='model_pk = True')
    if name == 'data_free':
        return with_lines(base, workdir, 'main.ini',
                          data='has_datafile = False')
    raise ValueError(name)


def with_output(main, results):
    """`main` with [output] filename = `results`, write_pk and write_cf
    (in place)."""
    import configparser
    parser = configparser.ConfigParser()
    parser.optionxform = str
    parser.read(main)
    parser['output'].update(filename=str(results), write_pk='True',
                            write_cf='True')
    with open(main, 'w') as fh:
        parser.write(fh)
    return Path(main)


def configuration_values(main):
    from make_torch_port_f32_models_goldens import sampled_truth
    return sampled_truth(main)


def draw(truth, n_rows, seed=0):
    """Rows 1% around `truth` (0.001 around a zero value)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {n: (v + 0.01 * (abs(v) or 0.1) * rng.normal(size=n_rows)).tolist()
            for n, v in truth.items()}


def row(points, i):
    return {n: v[i] for n, v in points.items()}


def tiny_jobs(work):
    """The tiny jobs, keyed as the 'tiny' record; `run_in` says which
    process runs each: every job runs in both dtypes."""
    work = Path(work)
    jobs = {}
    for name in ('marg', 'marg_in_fit'):
        main = make_tiny(name, work / name)
        points = draw(configuration_values(main), TINY_POINTS)
        derived = draw(configuration_values(main), DERIVED_ROWS, seed=1)
        jobs[f'{name}/dense'] = {
            'kind': 'chi2', 'main': str(main), 'regime': 'dense',
            'points': points, 'derivative_points': {'0': row(points, 0)},
            'coeff_point': row(points, 0),
            'derived_rows': [row(derived, i) for i in range(DERIVED_ROWS)]}
        if name == 'marg':
            jobs['marg/grid'] = {'kind': 'chi2', 'main': str(main),
                                 'regime': 'grid', 'points': points}
    main = make_tiny('components', work / 'components')
    jobs['components'] = {'kind': 'components', 'main': str(main),
                          'regime': 'dense',
                          'point': configuration_values(main)}
    for name in ('model_pk', 'direct', 'data_free'):
        jobs[name] = {'kind': name, 'main': str(make_tiny(name, work / name)),
                      'regime': 'dense', 'n_mocks': 1}
    return jobs


def fit_file_jobs(work):
    """components_fit in each dtype: its own files per run (run_vega
    writes beside them)."""
    jobs = {}
    for dtype in ('f32', 'f64'):
        main = make_tiny('components_fit', Path(work) / dtype)
        jobs[dtype] = {'kind': 'fit_file', 'main': str(main),
                       'fits': str(Path(work) / dtype / 'results.fits')}
    return jobs


def full_jobs(work):
    """The full jobs on the JAX side's files, and the f64 jobs among
    them."""
    from jax_dr16pub_dataset import make_jax_dr16_published_dataset
    from jax_metal_dataset import make_jax_metal_dataset
    from make_torch_port_marg_goldens import MARG_NOISE
    from make_torch_port_options_goldens import with_lines
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu_torch.testing import (DESI_METALS, desi_extra_model,
                                        marg_extra_model, with_control)
    work = Path(work)
    marg = json.loads(MARG_GOLDENS.read_text())
    mc = json.loads(MC_GOLDENS.read_text())
    run_vega = json.loads(RUN_VEGA_GOLDENS.read_text())
    names = marg['names']
    marg_main = make_jax_metal_dataset(
        work / 'marg', list(DESI_METALS), cross=True, size='full',
        sample=marg['sample'],
        extra_model=marg_extra_model(desi_extra_model()),
        new_metals=True, with_distortion=True, noise=MARG_NOISE)
    in_fit_main = with_control(marg_main, 'marginalize-in-fit = True',
                               Path(marg_main).parent / 'main_in_fit.ini')
    best = dict(zip(names, marg['in_fit']['fit_dense']['values']))
    jobs = {
        'marg': {'kind': 'chi2', 'main': str(marg_main), 'regime': 'dense',
                 'points': marg['cov']['params']},
        'marg_in_fit': {
            'kind': 'chi2', 'main': str(in_fit_main), 'regime': 'dense',
            'points': marg['in_fit']['params'],
            'derivative_points': {
                'bestfit': best,
                'derivative_0': marg['in_fit']['derivative_points'][0]},
            'coeff_point': best}}
    f64 = {'marg_in_fit': {
        'kind': 'chi2', 'main': str(in_fit_main), 'regime': 'dense',
        'derivative_points': {'bestfit': best}, 'coeff_point': best}}
    components_main = make_jax_dr16_published_dataset(
        work / 'components', size='full', components=True)
    jobs['components'] = {'kind': 'components',
                          'main': str(components_main), 'regime': 'dense',
                          'point': run_vega['point']}
    mc_ini = make_synthetic_dataset(work / 'mc', cross=True, size='full',
                                    sample=mc['sample'],
                                    extra_control=mc['mc_control'])
    jobs['direct'] = {'kind': 'direct', 'regime': 'dense',
                      'main': str(with_lines(
                          mc_ini, work, 'direct.ini',
                          control='use_full_pk_for_mc = True', sample={}))}
    jobs['model_pk'] = {'kind': 'model_pk', 'regime': 'dense',
                        'main': str(with_lines(mc_ini, work, 'model_pk.ini',
                                               control='model_pk = True'))}
    jobs['data_free'] = {'kind': 'data_free', 'regime': 'dense',
                         'main': str(with_lines(
                             mc_ini, work, 'data_free.ini',
                             data='has_datafile = False'))}
    return jobs, f64


def run_f32(jobs, work, env, label):
    job_file = Path(work) / f'jobs_{label}.json'
    job_file.write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, '-c', F32_SCRIPT, str(job_file),
         str(Path(__file__).resolve().parent)],
        capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ['MPLBACKEND'] = 'Agg'
    os.environ.pop('VEGA_TPU_FACTORED', None)
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)

    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    seconds = {}
    tiny, full = {}, {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        t0 = time.perf_counter()
        jobs = tiny_jobs(work / 'tiny')
        fit_jobs = fit_file_jobs(work / 'fit')
        seconds['tiny_datasets'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f64 = {key: run_job(job) for key, job in jobs.items()}
        f64_fit = run_job(fit_jobs['f64'])
        seconds['tiny_f64'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f32 = run_f32({**jobs, 'components_fit': fit_jobs['f32']}, work,
                      env, 'tiny')
        seconds['tiny_f32'] = time.perf_counter() - t0
        for key, job in jobs.items():
            tiny[key] = {'job': {k: v for k, v in job.items()
                                 if k not in ('main', 'kind', 'regime')},
                         'f32': f32[key], 'f64': f64[key]}
        tiny['components_fit'] = {'f32': f32['components_fit'],
                                  'f64': f64_fit}

        t0 = time.perf_counter()
        jobs, jobs64 = full_jobs(work / 'full')
        seconds['full_datasets'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f64 = {key: run_job(job) for key, job in jobs64.items()}
        seconds['full_f64'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f32 = run_f32(jobs, work, env, 'full')
        seconds['full_f32'] = time.perf_counter() - t0
        for key, job in jobs.items():
            full[key] = {'job': {k: v for k, v in job.items()
                                 if k not in ('main', 'kind', 'regime')},
                         'f32': f32[key]}
            if key in f64:
                full[key]['f64'] = f64[key]
    for size, records in (('tiny', tiny), ('full', full)):
        for key, record in records.items():
            for dtype in ('f32', 'f64'):
                if 'error' in record.get(dtype, {}):
                    print(f'{size} {key} {dtype}: {record[dtype]["error"]}')
            if record['f32'].get('dtype', 'float32') != 'float32':
                raise SystemExit(f'{size} {key} ran in '
                                 f'{record["f32"]["dtype"]}')
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'path': 'vega_tpu under VEGA_TPU_X64=0 (f32) and, for the tiny '
                'records and full marg_in_fit\'s best fit, x64 (f64), CPU, '
                'VEGA_TPU_DS_MATMUL=0, OMP_NUM_THREADS=1',
        'tiny_configs': 'make_tiny(): the port\'s dataset functions at '
                        "size='tiny' on the CPU",
        'full_configs': {
            'marg': 'make_torch_port_marg_goldens.py\'s files',
            'components': 'make_torch_port_run_vega_goldens.py\'s files',
            'mc': 'make_torch_port_options_goldens.py\'s mc files'},
        'made_by': 'tests/tools/make_torch_port_f32_options_goldens.py',
        'all_rmin_cut': ALL_RMIN_CUT,
        'tiny': tiny, 'full': full,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}')


if __name__ == '__main__':
    main()
