"""The port's counterpart of the eBOSS_DR16 synthetic example
(examples/eBOSS_DR16/run_synthetic_torch.py) on the CPU, as
tests/test_dr16_example.py runs vega_tpu's: its functions at nt = 12,
the combined four-correlation fit (ap, at on the grid payload) and its
global-covariance variant (dense), against vega_tpu's fits of the same
files, committed in tests/data/torch_port_examples_goldens.json by
tests/tools/make_torch_port_examples_goldens.py.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
from pathlib import Path

from test_torch_examples import EXAMPLES, load

REPO = Path(__file__).resolve().parents[1]
GOLDENS = json.loads((REPO / 'tests' / 'data'
                      / 'torch_port_examples_goldens.json').read_text())
# fits against vega_tpu's (chip_smoke.py's FIT_VALUE_SIGMA and
# FIT_ERROR_RTOL): on the grid payload, which each package sweeps
# itself, and on the dense path
GATES = {'combined': (1e-2, 1e-3), 'combined-globalcov': (1e-3, 1e-5)}


def test_combined_and_global_cov_fits(tmp_path):
    ex = load(EXAMPLES / 'eBOSS_DR16' / 'run_synthetic_torch.py')
    assert set(ex.FIT_TYPES) == {'auto', 'cross', 'combined'}
    nt = GOLDENS['dr16_nt']
    mains = ex.build_configs(tmp_path, nt)
    assert set(mains) == {'auto', 'cross', 'combined'}
    ex.regenerate_from_truth(tmp_path, mains['combined'], nt, device='cpu')
    fits = {'combined': ex.run_fit('combined', mains['combined'],
                                   device='cpu')}
    gcov = ex.make_global_cov(tmp_path, mains['combined'], device='cpu')
    gmains = ex.build_configs(tmp_path, nt, extension='gcov',
                              global_cov_file=gcov,
                              fit_types={'combined':
                                         ex.FIT_TYPES['combined']})
    fits['combined-globalcov'] = ex.run_fit(
        'combined-globalcov', gmains['combined'], device='cpu')
    for label, (values, errors) in fits.items():
        want = GOLDENS['run_synthetic'][label]
        sigma, err_rtol = GATES[label]
        assert set(values) >= set(want['values'])
        for name, value in want['values'].items():
            error = want['errors'][name]
            assert abs(values[name] - value) <= sigma * error, (label, name)
            assert abs(errors[name] / error - 1) <= err_rtol, (label, name)
    # block-diagonal global cov == per-corr covs: the same best fit
    for par in ('ap', 'at', 'bias_LYA', 'beta_LYA'):
        assert abs(fits['combined-globalcov'][0][par]
                   - fits['combined'][0][par]) < 1e-5
