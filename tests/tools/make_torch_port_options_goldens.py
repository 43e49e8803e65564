"""Write tests/data/torch_port_options_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for the options phase of chip_smoke.py, on
the same seeded full-size files the card's earlier phases write:

- 'desi_dr3', the configuration synthetic-desi-dr3-full: the files of
  synthetic-desi-full (tests/tools/jax_metal_dataset.py with the desi
  goldens' sample and [control], as tests/tools/
  make_torch_port_desi_goldens.py and the desi phase build them), the
  auto and the cross copied by vega_tpu_torch.testing.with_blinding with
  BLINDING = desi_dr3 and a seeded DA_BLIND column (the cross's line of
  sight reversed: BuildConfig's lyaxqso takes LYA first), and the configs
  of DESI DR1's baseline written by vega_tpu's BuildConfig
  (testing.write_desi_example_configs: the example's options, 17 names,
  priors and parameters): the config files as text (the date and
  git-hash lines blanked, the directories replaced by '<desi>' and
  '<out>'), chi2_batch at 8 points drawn 1% around the configuration's
  values on the blinded files and on unblinded copies of the same
  configs, and minimize() (VEGA_TPU_FACTORED=0);
- 'direct', use_full_pk_for_mc on synthetic-full: the files of the mc
  phase (tests/tools/make_torch_port_mc_goldens.py's SAMPLE and
  MC_CONTROL) with an empty [sample] (no initial fit) and
  use_full_pk_for_mc = True: the fiducial of
  get_fiducial_for_monte_carlo (compute_direct at [mc parameters]) in
  full, and MonteCarloEngine.fit_mocks on N_MOCKS numpy mocks around it
  (np.random.default_rng(MOCK_SEED) per correlation, fid_masked + z @ L.T)
  over (ap, at, bias_LYA, beta_LYA);
- 'model_pk', the same files with model_pk = True: compute_model's
  multipoles (4, 814) per correlation in full;
- 'data_free', the same files with has_datafile = False in each
  correlation: what vega_tpu's interface holds and the exception each
  evaluation raises;
- the tool's own run time, by part.

The pair histograms of the new-metals matrices run on one OpenMP thread
(OMP_NUM_THREADS=1, set before any library loads), where vega_tpu's sums
do not move from run to run.

Usage (from the repo root; several minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_options_goldens.py

`--size tiny --out <path>` writes the same record on tiny files (seconds),
for a rehearsal of the phase on the CPU.
"""

from __future__ import annotations

import os

os.environ['OMP_NUM_THREADS'] = '1'

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_options_goldens.json'
DESI_GOLDENS = REPO / 'tests' / 'data' / 'torch_port_desi_goldens.json'
MC_GOLDENS = REPO / 'tests' / 'data' / 'torch_port_mc_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

N_POINTS = 8
POINTS_SEED = 17
MOCK_NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
N_MOCKS = 4
MOCK_SEED = 20261018
# the seeds of the blinded columns (testing.with_blinding)
BLIND_SEEDS = {'auto': 0, 'cross': 1}
HEADER = re.compile(r'^# (File written on|vega_tpu(_torch)? git hash:) .*$',
                    re.MULTILINE)
DATA_FREE_CALLS = ('compute_model', 'compute_model_no_init', 'chi2',
                   'chi2_batch')


def config_texts(out_dir, desi_dir):
    """{file name: text} of the ini files BuildConfig wrote into
    `out_dir`, the date and git-hash lines blanked and the two
    directories replaced by '<out>' and '<desi>' (chip_smoke.py compares
    its own so)."""
    return {p.name: HEADER.sub('#', p.read_text())
            .replace(str(out_dir), '<out>').replace(str(desi_dir), '<desi>')
            for p in sorted(Path(out_dir).glob('*.ini'))}


def blinded_files(desi_dir, out_dir, blind=True):
    """The desi files copied for the configuration: desi_dr3 with
    DA_BLIND (blind) or as read (BLINDING none), the cross reversed."""
    from vega_tpu_torch.testing import with_blinding
    strategy = 'desi_dr3' if blind else 'none'
    return {
        'auto': with_blinding(desi_dir / 'cf_synthetic.fits', strategy,
                              out_dir / 'cf_desi.fits',
                              seed=BLIND_SEEDS['auto'], blind_column=blind),
        'cross': with_blinding(desi_dir / 'xcf_synthetic.fits', strategy,
                               out_dir / 'xcf_desi.fits',
                               seed=BLIND_SEEDS['cross'], blind_column=blind,
                               flip_rp=True),
        'stack': desi_dir / 'delta_stack.fits',
        'catalog': desi_dir / 'qso_catalog.fits',
        'template': desi_dir / 'fiducial_eh98.fits'}


def draw_points(params, names):
    """N_POINTS rows 1% around the configuration's values (0.001 around a
    zero value)."""
    import numpy as np
    rng = np.random.default_rng(POINTS_SEED)
    return {n: (params[n] + 0.01 * (abs(params[n]) or 0.1)
                * rng.normal(size=N_POINTS)).tolist() for n in names}


def desi_dr3(work, seconds, size):
    import numpy as np
    from jax_metal_dataset import make_jax_metal_dataset
    from vega_tpu.build_config import BuildConfig
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import (DESI_METALS, desi_extra_model,
                                        write_desi_example_configs)

    desi = json.loads(DESI_GOLDENS.read_text())
    t0 = time.perf_counter()
    desi_dir = Path(work) / 'desi'
    make_jax_metal_dataset(
        desi_dir, list(DESI_METALS), cross=True, size=size,
        sample=desi['sample'], extra_model=desi_extra_model(),
        new_metals=True, global_cov=True, extra_control=desi['extra_control'])
    seconds['desi_dataset'] = time.perf_counter() - t0
    record = {}
    vegas = {}
    for label, blind in (('blinded', True), ('unblinded', False)):
        out = Path(work) / f'desi_dr3_{label}'
        out.mkdir()
        main = write_desi_example_configs(
            BuildConfig, out, blinded_files(desi_dir, out, blind))
        if blind:
            record['configs'] = config_texts(out, desi_dir)
            record['main'] = Path(main).name
        vegas[label] = VegaInterface(main)
    vega = vegas['blinded']
    names = list(vega.sample_params['limits'])
    points = draw_points(vega.params, names)
    batch = {n: np.asarray(v) for n, v in points.items()}
    t0 = time.perf_counter()
    for label, v in vegas.items():
        record[f'chi2_{label}'] = [
            float(c) for c in np.asarray(v.chi2_batch(batch))]
    record['chi2_default'] = float(vega.chi2())
    seconds['desi_dr3_chi2'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vega.minimize()
    seconds['desi_dr3_fit'] = time.perf_counter() - t0
    best = vega.bestfit
    record.update(
        names=names, params=points,
        blinded=bool(vega._blind), rnsps=vega._rnsps,
        fit={'values': [best.values[n] for n in names],
             'errors': [best.errors[n] for n in names],
             'fval': float(best.fmin.fval), 'edm': float(best.fmin.edm),
             'is_valid': bool(best.fmin.is_valid),
             'seconds': seconds['desi_dr3_fit']})
    return record


def with_lines(main, work, name, control='', sample=None, data=''):
    """A copy of `main` named `name` in `work` with [control] `control`
    lines, [sample] replaced by `sample` when given, and `data` lines
    under each correlation's [data] (its ini copied beside it)."""
    from vega_tpu_torch.testing import with_control, with_sample
    path = Path(work) / name
    text = Path(main).read_text()
    if data:
        for ini in re.findall(r'^ini files = (.*)$', text, re.MULTILINE
                              )[0].split():
            copy = Path(work) / f'{Path(name).stem}_{Path(ini).name}'
            copy.write_text(Path(ini).read_text().replace(
                '[data]\n', f'[data]\n{data}\n', 1))
            text = text.replace(ini, str(copy))
    path.write_text(text)
    if sample is not None:
        with_sample(path, sample, path)
    if control:
        with_control(path, control, path)
    return path


def data_free_record(vega):
    """What vega_tpu's interface without data holds, and the exception
    each evaluation raises."""
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
        except Exception as exc:        # recorded, not carried on from
            raises[call] = type(exc).__name__
        else:
            raises[call] = None
    return {'has_data': bool(vega._has_data),
            'data': {n: d is None for n, d in vega.data.items()},
            'models': sorted(vega.models), 'plots': vega.plots is None,
            'corr_num_marg_modes': vega.corr_num_marg_modes,
            'raises': raises}


def synthetic_full_options(work, seconds, size):
    import numpy as np
    from make_torch_port_mc_goldens import numpy_mocks, sample_subset
    from vega_tpu.parallel import MonteCarloEngine
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface

    mc = json.loads(MC_GOLDENS.read_text())
    t0 = time.perf_counter()
    mc_ini = make_synthetic_dataset(Path(work) / 'mc', cross=True,
                                    size=size, sample=mc['sample'],
                                    extra_control=mc['mc_control'])
    seconds['mc_dataset'] = time.perf_counter() - t0
    out = {}

    t0 = time.perf_counter()
    vega = VegaInterface(with_lines(mc_ini, work, 'direct.ini',
                                    control='use_full_pk_for_mc = True',
                                    sample={}))
    fiducial = vega.get_fiducial_for_monte_carlo()
    mocks = numpy_mocks(vega, fiducial, N_MOCKS, MOCK_SEED)
    fits = MonteCarloEngine(vega).fit_mocks(
        mocks, sample_subset(vega.mc_config['sample'], MOCK_NAMES))
    seconds['direct'] = time.perf_counter() - t0
    out['direct'] = {
        'mc_params': vega.mc_config['params'],
        'fiducial': {n: np.asarray(f).tolist() for n, f in fiducial.items()},
        'mocks': {'seed': MOCK_SEED, 'n_mocks': N_MOCKS,
                  'names': list(fits['names']),
                  **{key: np.asarray(fits[key]).tolist()
                     for key in ('values', 'errors', 'chisq', 'valid')}}}

    t0 = time.perf_counter()
    vega = VegaInterface(with_lines(mc_ini, work, 'model_pk.ini',
                                    control='model_pk = True'))
    out['model_pk'] = {n: np.asarray(m).tolist() for n, m in
                       vega.compute_model(run_init=False).items()}
    seconds['model_pk'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vega = VegaInterface(with_lines(mc_ini, work, 'data_free.ini',
                                    data='has_datafile = False'))
    out['data_free'] = data_free_record(vega)
    seconds['data_free'] = time.perf_counter() - t0
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--size', default='full', choices=('full', 'tiny'))
    parser.add_argument('--out', default=str(OUT))
    args = parser.parse_args()
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ['VEGA_TPU_FACTORED'] = '0'
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)

    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        record = {'desi_dr3': desi_dr3(work, seconds, args.size)}
        # the mc phase's files: the mock fits take the dense path there
        os.environ.pop('VEGA_TPU_FACTORED', None)
        record.update(synthetic_full_options(work, seconds, args.size))
    seconds['tool'] = time.perf_counter() - t_start
    Path(args.out).write_text(json.dumps({
        'config': {
            'desi_dr3': 'the desi phase files (make_jax_metal_dataset with '
                        'the desi goldens\' sample and extra_control), '
                        'with_blinding(desi_dr3, seeds auto 0 / cross 1, '
                        'the cross flip_rp), write_desi_example_configs',
            'synthetic_full': 'the mc phase files (make_synthetic_dataset '
                              "cross=True, size='full', the mc goldens' "
                              'sample and mc_control)'},
        'path': 'vega_tpu dense (VEGA_TPU_FACTORED=0 for desi_dr3), CPU, '
                'f64, OMP_NUM_THREADS=1',
        'made_by': 'tests/tools/make_torch_port_options_goldens.py',
        'size': args.size,
        'blind_seeds': BLIND_SEEDS, 'points_seed': POINTS_SEED,
        **record,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {args.out} in {seconds["tool"]:.1f} s: {seconds}; desi_dr3 fit '
          f'fval {record["desi_dr3"]["fit"]["fval"]!r}')


if __name__ == '__main__':
    main()
