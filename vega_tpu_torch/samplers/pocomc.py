"""PocoMC settings routed to the native SMC sampler.

Counterpart of vega_tpu/samplers/pocomc.py as it runs without pocomc:
the same config goes to the native SMC sampler (samplers/smc.py), which
accepts the PocoMC option names (n_effective, seed). The code that
runs the external pocomc package is not ported.
"""

from __future__ import annotations

from .smc import SMCSampler


class PocoMC:
    """(vega_tpu/samplers/pocomc.py:29-34)"""

    def __new__(cls, sampler_config, limits, log_lik_func):
        print('pocomc not available: using the native batched SMC '
              'sampler with the PocoMC settings.')
        return SMCSampler(sampler_config, limits, log_lik_func)
