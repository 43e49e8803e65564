"""Write tests/data/torch_port_f32_campaign_goldens.json: the JAX package's
(vega_tpu) f32 throughput mode (VEGA_TPU_X64=0) on the CPU in the
workloads that call the likelihood many times, and its f64 beside it:

- 'tiny': the tiny auto+cross dataset of tests/test_torch_f32_campaigns.py
  (TINY: noise 1, seed 3, (ap, at, bias_LYA, beta_LYA) sampled, 8 x 8 grid
  nodes, a [monte carlo] section over (bias_LYA, beta_LYA)), written by
  the port's make_synthetic_dataset on the CPU (the same files as
  vega_tpu's):
  - 'traceable': BatchedLikelihood.traceable_log_lik at 7 seeded rows, on
    the grid payload and in the dense regime (VEGA_TPU_FACTORED=0);
  - 'scan': batched_chi2_scan over an 8 x 8 (ap, at) grid, bias_LYA and
    beta_LYA re-minimised at each point on the payload: fval, the free
    values, the rows' `valid` (the scan's own body, which returns them),
    max |projected gradient| after max_iterations - 1 steps (a second
    run; what the loop's stopping test read last: a row above 1e-6 ran
    to max_iterations), which rows still moved at the last iteration,
    and in f64 the free values' errors from the Hessian there;
  - 'mocks': MonteCarloEngine.fit_mocks on 4 numpy mocks (seed 5), dense
    over the four names at max_iterations = DENSE_ITERATIONS and through
    the nuisance collapse at the default 200: values, errors, chisq,
    valid, and max |projected gradient| at the result;
  - 'run_monte_carlo': Analysis.run_monte_carlo, 2 mocks, seed 11, on a
    fresh interface; 'initialize_monte_carlo': its masked mocks and chi^2
    at POINT and at POINT's nuisance after it;
  - 'hmc_step': one HMC trajectory of vega_tpu's _build_scan on the toy
    chi^2 of tests/test_torch_hmc.py with hand-fed random numbers;
  - 'mc_script': the column formats of run_vega_mc's monte_carlo.fits on
    the tiny auto configuration of tests/test_torch_output.py's mc_ini;
- 'full': MonteCarloEngine.fit_mocks on the 4 numpy mocks per sample set
  of tests/data/torch_port_mc_goldens.json (its configuration, seeds and
  draw: make_torch_port_mc_goldens.py), dense and through the collapse,
  at the default max_iterations, in f32; chip_smoke.py's f32_campaigns
  phase holds the port's f32 mock fits against them.

The f32 numbers come from a subprocess under VEGA_TPU_X64=0 (vega_tpu
reads the x64 switch when it is imported), the f64 ones from another
with x64; VEGA_TPU_DS_MATMUL=0 and no payload cache in both.

Usage (from the repo root; about 8 minutes on 8 cores):
    JAX_PLATFORMS=cpu \
        python tests/tools/make_torch_port_f32_campaign_goldens.py
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_f32_campaign_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
NUISANCE = ('bias_LYA', 'beta_LYA')
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
MC_PARAMS = {'bias_LYA': -0.117, 'beta_LYA': 1.67}
CONTROL = ('grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
           'mc_seed = 7\n\n[monte carlo]\n'
           'bias_LYA = -1.0 0.0 -0.12 0.01\nbeta_LYA = 0.0 3.0 1.6 0.1\n\n'
           '[mc parameters]\n'
           + ''.join(f'{k} = {v}\n' for k, v in MC_PARAMS.items()))
TINY = dict(cross=True, size='tiny', sample=SAMPLE, seed=3, noise=1.0,
            extra_control=CONTROL)
SCAN_AXIS = (0.96, 1.04, 8)
SCAN_ITERATIONS = 100           # batched_chi2_scan's default
MOCK_SEED, N_MOCKS = 5, 4
DENSE_ITERATIONS = 30           # the dense fits' cap in the tiny test
MC_SEED, MC_MOCKS = 11, 2
POINT = {'ap': 1.01, 'at': 0.99, 'bias_LYA': -0.118, 'beta_LYA': 1.65}
# tests/test_torch_hmc.py's toy and one trajectory's inputs
TOY_LIMITS = {'a': (-2.0, 3.0), 'b': (0.0, 4.0), 'c': (-1.0, 1.0)}
TOY_MU = [0.4, 1.7, -0.2]
TOY_A = [[3.0, 0.8, -0.4], [0.8, 2.0, 0.3], [-0.4, 0.3, 5.0]]
HMC_SEED, HMC_CHAINS, HMC_LEAP, HMC_EPS, HMC_UNIFORM = 8, 6, 5, 0.65, 0.45
MC_SCRIPT_CONTROL = ('run_montecarlo = True\nnum_mc_mocks = 4\n'
                     'mc_seed = 1\nrun_mc_fits = True')
MC_SCRIPT_SECTIONS = ('\n[monte carlo]\nbias_LYA = True\nbeta_LYA = True\n'
                      '\n[mc parameters]\nbias_LYA = -0.117\n'
                      'beta_LYA = 1.67\n')

SCRIPT = r"""
import json, os, sys
os.environ['VEGA_TPU_X64'] = sys.argv[3]
os.environ['VEGA_TPU_DS_MATMUL'] = '0'
os.environ['VEGA_TPU_GRID_CACHE'] = '0'
os.environ.pop('VEGA_TPU_FACTORED', None)
os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
import jax
jax.config.update('jax_platforms', 'cpu')
sys.path.insert(0, sys.argv[2])
import make_torch_port_f32_campaign_goldens as tool
job = json.loads(open(sys.argv[1]).read())
print(json.dumps(getattr(tool, job['run'])(**job['args'])))
"""


def theta_rows(names, n=7, seed=0):
    """tests/test_torch_samplers.py's rows: n points inside the node
    domain, columns ordered as `names`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    columns = {'ap': rng.uniform(0.8, 1.2, n), 'at': rng.uniform(0.8, 1.2, n),
               'bias_LYA': -0.117 * (1 + 0.05 * rng.normal(size=n)),
               'beta_LYA': 1.67 * (1 + 0.05 * rng.normal(size=n))}
    return np.stack([columns[name] for name in names], axis=1)


def numpy_mocks(vega, fiducial, n_mocks, seed):
    """fid_masked + z @ L.T per correlation, z from
    np.random.default_rng(seed) in corr_items order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    for name, data in vega.data.items():
        mask = data.data_mask
        chol = np.linalg.cholesky(data.cov_mat[np.ix_(mask, mask)])
        z = rng.standard_normal((n_mocks, int(mask.sum())))
        out[name] = np.asarray(fiducial[name])[mask] + z @ chol.T
    return out


def sample_subset(sample_params, names):
    return {key: {n: sample_params[key][n] for n in names}
            for key in ('limits', 'values', 'errors', 'fix')}


def jax_scan(vega, grids, max_iterations):
    """vega_tpu's batched_chi2_scan (vega_tpu/parallel/batch.py:421-485)
    with the rows' `valid` kept: (x (n, 2), chi2 (n,), valid (n,),
    gradient): gradient(x) is max |projected gradient| per row at free
    values x, what the Newton's stopping test reads (its loop's last
    carry holds it at the values after max_iterations - 1 steps)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vega_tpu.parallel import batch as jbatch
    sample_params = vega.sample_params
    scan_names = list(grids)
    free = [n for n in sample_params['limits'] if n not in scan_names]
    axes = np.meshgrid(*[np.asarray(grids[n]) for n in scan_names],
                       indexing='ij')
    scan_vals = np.stack([ax.ravel() for ax in axes], axis=-1)
    mesh = jbatch.make_device_mesh(axis_name='batch')
    x0 = jnp.array([sample_params['values'][n] for n in free])
    lo = jnp.array([sample_params['limits'][n][0] for n in free])
    hi = jnp.array([sample_params['limits'][n][1] for n in free])
    vega._ensure_static_refs()
    data_vecs = {k: jnp.asarray(v)
                 for k, v in vega._current_data_vecs().items()}
    cov_scales = vega._current_cov_scales()

    def chi2_of(x, point, statics, collapsed):
        params = {n: x[i] for i, n in enumerate(free)}
        params.update({n: point[i] for i, n in enumerate(scan_names)})
        return vega._chi2_graph_bound(params, data_vecs, cov_scales,
                                      statics, collapsed)[0]

    collapsed = vega._device_collapsed(vega.get_collapsed(free + scan_names))
    x, _, _, chi2, valid = jbatch._newton_minimize_batched(
        chi2_of, x0, lo, hi, jnp.asarray(scan_vals), mesh, 'batch',
        max_iterations, collapsed=collapsed)
    from vega_tpu.statics import STATICS
    grad = jax.jit(jax.vmap(jax.grad(chi2_of), in_axes=(0, 0, None, None)))

    def gradient(xs):
        g = np.asarray(grad(jnp.asarray(xs), jnp.asarray(scan_vals),
                            STATICS.device_tree(), collapsed))
        lo_, hi_ = np.asarray(lo), np.asarray(hi)
        eps = 1e-12 + 1e-9 * np.abs(xs)
        active = (((xs <= lo_ + eps) & (g > 0))
                  | ((xs >= hi_ - eps) & (g < 0)))
        return np.max(np.abs(np.where(active, 0.0, g)), axis=1)

    return np.asarray(x), np.asarray(chi2), np.asarray(valid), gradient


def projected_gradient(vega, names, sample, x, data_vecs):
    """max |projected gradient| per row of vega_tpu's chi^2 at x (rows of
    `names`), each row against its own data vectors (mock fits): the
    quantity the Newton's stopping and validity tests read."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vega_tpu.statics import STATICS
    collapsed = vega._device_collapsed(vega.get_collapsed(
        names, with_data_terms=False))
    statics = STATICS.device_tree()
    cov_scales = {name: 1.0 for name in vega.corr_items}

    def chi2(xr, dv):
        return vega._chi2_graph_bound(dict(zip(names, xr)), dv, cov_scales,
                                      statics, collapsed)[0]

    g = np.asarray(jax.jit(jax.vmap(jax.grad(chi2)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in data_vecs.items()}))
    lo = np.array([sample['limits'][n][0] for n in names])
    hi = np.array([sample['limits'][n][1] for n in names])
    eps = 1e-12 + 1e-9 * np.abs(x)
    active = ((x <= lo + eps) & (g > 0)) | ((x >= hi - eps) & (g < 0))
    return np.max(np.abs(np.where(active, 0.0, g)), axis=1)


def tiny_run(main, auto_main, out_dir):
    """vega_tpu's numbers on the tiny configuration, in this process's
    dtype."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vega_tpu.parallel import BatchedLikelihood, MonteCarloEngine
    from vega_tpu.samplers.hmc import HMC
    from vega_tpu.scripts import run_vega_mc
    from vega_tpu.vega_interface import VegaInterface

    out = {}
    # --- the traceable log-likelihood, grid and dense
    traceable = {}
    for regime in ('grid', 'dense'):
        if regime == 'dense':
            os.environ['VEGA_TPU_FACTORED'] = '0'    # read at trace time
        vega = VegaInterface(main)
        theta = theta_rows(NAMES)
        batch_fn, statics, collapsed = BatchedLikelihood(
            vega).traceable_log_lik(NAMES)
        logl = np.asarray(batch_fn(jnp.asarray(theta), statics, collapsed))
        traceable[regime] = {'dtype': str(logl.dtype),
                             'log_lik': logl.tolist()}
        os.environ.pop('VEGA_TPU_FACTORED', None)
    out['traceable'] = {'theta': theta_rows(NAMES).tolist(), **traceable}

    # --- the scan on the payload
    vega = VegaInterface(main)
    axis = np.linspace(*SCAN_AXIS)
    grids = {'ap': axis, 'at': axis}
    x, chi2, valid, gradient = jax_scan(vega, grids, SCAN_ITERATIONS)
    x_before = jax_scan(vega, grids, SCAN_ITERATIONS - 1)[0]
    last_gradient = gradient(x_before)
    scan = {'axis': list(SCAN_AXIS), 'free': list(NUISANCE),
            'dtype': str(chi2.dtype), 'fval': chi2.tolist(),
            'values': x.tolist(), 'valid': valid.tolist(),
            'last_gradient': last_gradient.tolist(),
            'ran_to_max_iterations': (last_gradient > 1e-6).tolist(),
            'moved_at_last_iteration': np.any(x != x_before,
                                              axis=1).tolist()}
    if chi2.dtype == np.float64:
        errors = []
        points = np.stack([a.ravel() for a in np.meshgrid(axis, axis,
                                                          indexing='ij')], 1)
        for (ap, at), row in zip(points, x):
            hess = vega.chi2_hessian({'ap': ap, 'at': at,
                                      **dict(zip(NUISANCE, row))},
                                     list(NUISANCE))
            h = np.array([[hess[a][b] for b in NUISANCE] for a in NUISANCE])
            errors.append(np.sqrt(np.diag(2.0 * np.linalg.inv(h))).tolist())
        scan['errors'] = errors
    out['scan'] = scan

    # --- mock fits, dense and through the collapse
    fiducial = vega.compute_model(MC_PARAMS, run_init=False)
    mocks = numpy_mocks(vega, fiducial, N_MOCKS, MOCK_SEED)
    out['mocks'] = {}
    for kind, names, cap in (('dense', NAMES, DENSE_ITERATIONS),
                             ('collapse', NUISANCE, 200)):
        sample = sample_subset(vega.sample_params, names)
        fits = MonteCarloEngine(vega).fit_mocks(mocks, copy.deepcopy(sample),
                                                max_iterations=cap)
        record = {key: np.asarray(fits[key]).tolist()
                  for key in ('values', 'errors', 'chisq', 'valid')}
        record.update(names=list(names), max_iterations=cap,
                      dtype=str(np.asarray(fits['chisq']).dtype),
                      max_abs_gradient=projected_gradient(
                          vega, list(names), sample,
                          np.asarray(fits['values']), mocks).tolist())
        out['mocks'][kind] = record

    # --- the serial loop and initialize_monte_carlo
    vega = VegaInterface(main)
    fid = vega.compute_model(run_init=False)
    vega.monte_carlo = True
    vega.analysis.run_monte_carlo(fid, num_mocks=MC_MOCKS, seed=MC_SEED)
    analysis = vega.analysis
    out['run_monte_carlo'] = {
        'bestfits': {p: np.asarray(v).tolist()
                     for p, v in analysis.mc_bestfits.items()},
        'chisq': [float(c) for c in analysis.mc_chisq],
        'valid': [bool(v) for v in analysis.mc_valid_minima]}
    vega = VegaInterface(main)
    got = vega.initialize_monte_carlo()
    out['initialize_monte_carlo'] = {
        'mocks': {name: np.asarray(got[name])[vega.data[name].data_mask]
                  .tolist() for name in vega.corr_items},
        'chi2_point': float(vega.chi2(POINT)),
        'chi2_nuisance': float(vega.chi2({n: POINT[n] for n in NUISANCE}))}

    # --- one HMC trajectory of the toy chi^2, random numbers by hand
    rng = np.random.default_rng(HMC_SEED)
    ndim = len(TOY_LIMITS)
    u0 = rng.normal(size=(HMC_CHAINS, ndim))
    z = rng.normal(size=ndim)
    m = rng.normal(size=(ndim, ndim))
    inv_mass = m @ m.T / ndim + 0.5 * np.eye(ndim)
    chol_mass = np.linalg.cholesky(np.linalg.inv(inv_mass))
    mu, a_mat = jnp.asarray(TOY_MU), jnp.asarray(TOY_A)

    def toy_chi2(x):
        d = x - mu
        return d @ (a_mat @ d) + 0.3 * jnp.sum(d ** 4)

    import configparser
    config = configparser.ConfigParser()
    config['HMC'] = {'path': str(out_dir), 'name': 'hmc',
                     'num_chains': str(HMC_CHAINS),
                     'num_leapfrog': str(HMC_LEAP)}
    sampler = HMC(config['HMC'], TOY_LIMITS, toy_chi2)
    draws = jax.random.normal, jax.random.uniform
    jax.random.normal = lambda key, shape=(), dtype=float: jnp.asarray(
        z, dtype=dtype)
    jax.random.uniform = lambda key, *a, **k: jnp.asarray(HMC_UNIFORM)
    try:
        run_block, init_chains = sampler._build_scan()
        v0, g0 = init_chains(jnp.asarray(u0))
        log_eps = jnp.asarray(np.log(HMC_EPS))
        carry, _, _, accs = run_block(
            jax.random.PRNGKey(0), (jnp.asarray(u0), v0, g0),
            jnp.asarray(inv_mass), jnp.asarray(chol_mass), 1, False,
            log_eps, (jnp.asarray(0.0), log_eps, log_eps))
    finally:
        jax.random.normal, jax.random.uniform = draws
    u, v, g = (np.asarray(t) for t in carry[1])
    out['hmc_step'] = {
        'u0': u0.tolist(), 'z': z.tolist(), 'uniform': HMC_UNIFORM,
        'inv_mass': inv_mass.tolist(), 'chol_mass': chol_mass.tolist(),
        'eps': HMC_EPS, 'n_leap': HMC_LEAP, 'dtype': str(u.dtype),
        'v0': np.asarray(v0).tolist(), 'g0': np.asarray(g0).tolist(),
        'u': u.tolist(), 'v': v.tolist(), 'g': g.tolist(),
        'accept_mean': float(np.asarray(accs)[0])}

    # --- run_vega_mc's file
    assert run_vega_mc.main([str(auto_main)]) == 0
    from vega_tpu_torch.io.fits import read_fits
    path = Path(auto_main).parent / 'mc_out' / 'monte_carlo' / \
        'monte_carlo.fits'
    out['mc_script'] = {
        hdu.name: {c: str(np.asarray(hdu[c]).dtype) for c in hdu.columns}
        for hdu in read_fits(path) if getattr(hdu, 'name', '')
        and hasattr(hdu, 'columns')}
    return out


def full_run(main):
    """vega_tpu's fit_mocks on the full configuration's golden mocks, in
    this process's dtype."""
    import numpy as np
    from make_torch_port_mc_goldens import SEEDS
    from vega_tpu.parallel import MonteCarloEngine
    from vega_tpu.vega_interface import VegaInterface
    vega = VegaInterface(main)
    fiducial = vega.compute_model(vega.mc_config['params'], run_init=False)
    engine = MonteCarloEngine(vega)
    out = {}
    for kind, names in (('dense', NAMES), ('collapse', NUISANCE)):
        mocks = numpy_mocks(vega, fiducial, 4, SEEDS[kind])
        t0 = time.perf_counter()
        fits = engine.fit_mocks(mocks, sample_subset(
            vega.mc_config['sample'], names))
        out[kind] = {'seed': SEEDS[kind], 'n_mocks': 4, 'names': list(names),
                     'max_iterations': 200,
                     'dtype': str(np.asarray(fits['chisq']).dtype),
                     'seconds': time.perf_counter() - t0,
                     **{key: np.asarray(fits[key]).tolist()
                        for key in ('values', 'errors', 'chisq', 'valid')}}
    return out


def mc_script_config(workdir, device):
    """tests/test_torch_output.py's mc_ini (a tiny auto configuration with
    run_montecarlo, 4 mocks and [monte carlo] over bias_LYA, beta_LYA),
    writing its results under <workdir>/mc_out."""
    import configparser
    from vega_tpu_torch.testing import make_synthetic_dataset
    main = make_synthetic_dataset(workdir, cross=False, size='tiny',
                                  noise=1.0, device=device,
                                  extra_control=MC_SCRIPT_CONTROL)
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read(main)
    config['output']['filename'] = str(Path(workdir) / 'mc_out' / 'output')
    with open(main, 'w') as fh:
        config.write(fh)
        fh.write(MC_SCRIPT_SECTIONS)
    return main


def subprocess_run(run, args, x64, work, env):
    job = Path(work) / f'job_{run}_{x64}.json'
    job.write_text(json.dumps({'run': run, 'args': args}))
    proc = subprocess.run(
        [sys.executable, '-c', SCRIPT, str(job),
         str(Path(__file__).resolve().parent), x64],
        capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    t_start = time.perf_counter()
    from make_torch_port_mc_goldens import MC_CONTROL
    from make_torch_port_mc_goldens import SAMPLE as FULL_SAMPLE
    from vega_tpu_torch.testing import make_synthetic_dataset

    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        mains = {}
        for dtype in ('f32', 'f64'):
            main = make_synthetic_dataset(work / f'tiny_{dtype}',
                                          device='cpu', **TINY)
            auto = mc_script_config(work / f'auto_{dtype}', 'cpu')
            mains[dtype] = (str(main), str(auto))
        full = make_synthetic_dataset(work / 'full', cross=True, size='full',
                                      device='cpu', sample=FULL_SAMPLE,
                                      extra_control=MC_CONTROL)
        tiny = {}
        for dtype, x64 in (('f32', '0'), ('f64', '1')):
            t0 = time.perf_counter()
            main, auto = mains[dtype]
            tiny[dtype] = subprocess_run(
                'tiny_run', {'main': main, 'auto_main': auto,
                             'out_dir': str(work)}, x64, work, env)
            seconds[f'tiny_{dtype}'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        full_f32 = subprocess_run('full_run', {'main': str(full)}, '0', work,
                                  env)
        seconds['full_f32'] = time.perf_counter() - t0
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'path': 'vega_tpu under VEGA_TPU_X64=0 (f32) and x64 (f64), CPU, '
                'VEGA_TPU_DS_MATMUL=0',
        'tiny_config': "vega_tpu_torch.testing.make_synthetic_dataset("
                       "workdir, device='cpu', **TINY)",
        'full_config': 'tests/tools/make_torch_port_mc_goldens.py\'s MC '
                       'configuration, seeds and draw',
        'made_by': 'tests/tools/make_torch_port_f32_campaign_goldens.py',
        'tiny': tiny, 'full': full_f32,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}')


if __name__ == '__main__':
    main()
