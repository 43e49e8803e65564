"""Generate the DESI Y1 baseline configs — mock edition, with the
PyTorch port (vega_tpu_torch).

Counterpart of the reference's examples/DESI_mock_setup. Identical
analysis structure to ../DESI_data_setup, with the mock-specific model
differences of the reference snapshot: gaussian full-shape smoothing
(applied to metals too), no Arinyo small-scale term, no instrumental
systematics, and no CIV metal.

Usage: same arguments as ../DESI_data_setup/make_configs_torch.py; fit
with python -m vega_tpu_torch.scripts.run_vega. Counterpart of
make_configs.py in this directory.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                       / 'DESI_data_setup'))
import make_configs_torch as data_setup  # noqa: E402

MOCK_OPTIONS = {
    'small_scale_nl': False,
    'desi-instrumental-systematics': False,
    'fullshape_smoothing': 'gauss',
    'fullshape_smoothing_metals': True,
    'metals': ['SiII(1190)', 'SiII(1193)', 'SiIII(1207)', 'SiII(1260)'],
}

if __name__ == '__main__':
    data_setup.SAMPLED = [p for p in data_setup.SAMPLED
                          if p not in ('bias_CIV(eff)',
                                       'desi_inst_sys_amp')]
    data_setup.main(extra_options=MOCK_OPTIONS)
