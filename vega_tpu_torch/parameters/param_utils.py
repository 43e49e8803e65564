"""Parameter metadata: default prior limits and step sizes.

Counterpart of vega_tpu/parameters/param_utils.py. The defaults file is
the JAX package's own, read by filesystem path.
"""

from __future__ import annotations

from ..utils import JAX_PACKAGE_DIR

DEFAULT_VALUES_FILE = JAX_PACKAGE_DIR / 'parameters' / 'default_values.txt'


def get_default_values():
    """Default prior limits and minimizer step sizes
    (reference: param_utils.py:100-123)."""
    defaults = {}
    with open(DEFAULT_VALUES_FILE) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            name, rest = line.split('=', 1)
            lo, hi, err = rest.split()
            defaults[name.strip()] = {
                'limits': (float(lo), float(hi)),
                'error': float(err),
            }
    return defaults
