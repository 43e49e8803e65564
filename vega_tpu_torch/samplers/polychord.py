"""PolyChord settings routed to the native nested sampler.

Counterpart of vega_tpu/samplers/polychord.py as it runs without
pypolychord: the same config goes to the batched NestedSampler
(samplers/nested.py), which accepts the PolyChord option names (num_live,
num_repeats, precision, resume, seed). The code that runs the external
pypolychord package is not ported.
"""

from __future__ import annotations

from .nested import NestedSampler


class Polychord:
    """(vega_tpu/samplers/polychord.py:28-35)"""

    def __new__(cls, sampler_config, limits, log_lik_func,
                derived_dict=None):
        print('pypolychord not available: using the native batched '
              'nested sampler with the PolyChord settings.')
        return NestedSampler(sampler_config, limits, log_lik_func,
                             derived_dict=derived_dict)
