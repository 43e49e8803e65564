"""The port's counterparts of the examples (examples/**/*_torch.py,
examples/tutorials_torch/) against the JAX package's originals, on the
CPU: the four config generators write the files vega_tpu's write, as
text, with tests/test_example_generators.py's arguments; tutorials 01,
02 and 07 run with --device cpu (01 and 02 on the tiny dataset) and
give vega_tpu's numbers, committed in
tests/data/torch_port_examples_goldens.json by
tests/tools/make_torch_port_examples_goldens.py (vega_tpu's own
tutorial tests are marked slow). Each tolerance stands beside its use.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / 'examples'
GOLDENS = json.loads((REPO / 'tests' / 'data'
                      / 'torch_port_examples_goldens.json').read_text())
# BuildConfig's header: the time of writing and the package's name
HEADER = re.compile(r'^# (File written on|vega_tpu(_torch)? git hash:) ')
CHI2_RTOL = 1e-10        # chi^2 and log L at a point, f64 both sides
MODEL_RTOL = 1e-12       # means of a model or of its components
# a fit against vega_tpu's from the same start (tests/
# test_torch_analysis.py's gates): values within FIT_SIGMA of their
# errors, errors and covariances within FIT_ERR_RTOL, chi^2 at the
# minimum within FIT_CHI2_ABS
FIT_SIGMA, FIT_ERR_RTOL, FIT_CHI2_ABS = 1e-3, 1e-5, 1e-8

GENERATORS = {
    'eBOSS_DR16': ['--data-dir', '/data/dr16'],
    'DESI_data_setup': [
        '--correlations-dir', '/data/corr', '--weights-lya', '/data/w_lya',
        '--weights-lyb', '/data/w_lyb', '--qso-cat', '/data/qso',
        '--global-cov', '/data/gcov.fits'],
    'DESI_mock_setup': [
        '--correlations-dir', '/data/corr', '--weights-lya', '/data/w_lya',
        '--weights-lyb', '/data/w_lyb', '--qso-cat', '/data/qso'],
    'lyacolore_mocks': ['--cf', '/data/cf_exp.fits', '--zeff', '2.3'],
}


def load(path):
    """An example script as a module (its main() not run)."""
    spec = importlib.util.spec_from_file_location(
        'example_' + path.stem.replace('-', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(relative, *args):
    return load(EXAMPLES / relative).main(['--device', 'cpu', *args])


def rel(got, want):
    return abs(got - want) / abs(want)


def written(out_dir):
    """{relative path: text} of every file under out_dir, BuildConfig's
    header lines dropped and out_dir itself written <out>."""
    texts = {}
    for path in sorted(out_dir.rglob('*')):
        if path.is_file():
            lines = [line for line in path.read_text().splitlines()
                     if not HEADER.match(line)]
            texts[str(path.relative_to(out_dir))] = '\n'.join(
                lines).replace(str(out_dir), '<out>')
    return texts


@pytest.mark.parametrize('setup', list(GENERATORS))
def test_config_generators_write_what_jax_writes(setup, tmp_path):
    """make_configs_torch.py and vega_tpu's make_configs.py, each in its
    own process with the same arguments: the same files with the same
    text, each naming vega_tpu_torch's run_vega in its help."""
    out = {}
    for package, script in (('jax', 'make_configs.py'),
                            ('port', 'make_configs_torch.py')):
        out[package] = tmp_path / package
        proc = subprocess.run(
            [sys.executable, str(EXAMPLES / setup / script),
             *GENERATORS[setup], '--out-dir', str(out[package])],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert proc.returncode == 0, proc.stderr[-3000:]
    port, jax = written(out['port']), written(out['jax'])
    assert port and sorted(port) == sorted(jax)
    for name in jax:
        assert port[name] == jax[name], name
    source = (EXAMPLES / setup / 'make_configs_torch.py').read_text()
    assert 'import vega_tpu.' not in source and 'from vega_tpu.' not in source
    if setup != 'DESI_mock_setup':
        assert 'python -m vega_tpu_torch.scripts.run_vega' in source


def test_tutorial_01_getting_started():
    """chi^2, log L and the model at a point, and the fit, as vega_tpu's
    tutorial on the same tiny dataset."""
    got = run_example('tutorials_torch/01_getting_started.py',
                      '--size', 'tiny')
    want = GOLDENS['tutorial_01']
    assert rel(got['chi2'], want['chi2']) <= CHI2_RTOL
    assert rel(got['log_lik'], want['log_lik']) <= CHI2_RTOL
    for name, mean in want['model_mean'].items():
        assert rel(got['model_mean'][name], mean) <= MODEL_RTOL
    for name, value in want['values'].items():
        error = want['errors'][name]
        assert abs(got['values'][name] - value) <= FIT_SIGMA * error
        assert rel(got['errors'][name], error) <= FIT_ERR_RTOL
    assert abs(got['fval'] - want['fval']) <= FIT_CHI2_ABS
    assert got['valid'] and want['valid']
    assert rel(got['covariance'], want['covariance']) <= FIT_ERR_RTOL


def test_tutorial_02_model_components():
    """The saved components and the direct-Pk model as vega_tpu's."""
    got = run_example('tutorials_torch/02_model_components.py',
                      '--size', 'tiny')
    want = GOLDENS['tutorial_02']
    assert got['pk_stages'] == want['pk_stages']
    assert got['xi_stages'] == want['xi_stages']
    assert got['peak_plus_smooth_is_full'] and \
        want['peak_plus_smooth_is_full']
    for key in ('pk_peak_mean', 'xi_dist_mean', 'direct_mean'):
        assert rel(got[key], want[key]) <= MODEL_RTOL, key


def test_tutorial_07_config_creation():
    """BuildConfig's files drive the interface: vega_tpu's chi^2."""
    got = run_example('tutorials_torch/07_config_creation.py')
    assert rel(got['chi2'], GOLDENS['tutorial_07']['chi2']) <= CHI2_RTOL


def test_examples_import_only_the_port():
    """Every counterpart imports vega_tpu_torch and nothing of vega_tpu
    (nor JAX), and defaults to the card."""
    scripts = (sorted((EXAMPLES / 'tutorials_torch').glob('0*.py'))
               + sorted(EXAMPLES.glob('**/*_torch.py')))
    assert len(scripts) == 14 + 1      # and dr16_subset's BAO demo
    for path in scripts:
        source = path.read_text()
        imports = re.findall(r'^\s*(?:from|import)\s+([\w.]+)', source,
                             flags=re.M)
        assert not [m for m in imports if m.split('.')[0] in
                    ('vega_tpu', 'jax')], path
        if 'make_configs' not in path.name:
            assert "default='cuda'" in source, path
    assert np.isfinite(GOLDENS['tool_seconds'])
