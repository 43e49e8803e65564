from vega_tpu_torch.parallel.batch import (  # noqa: F401
    BatchedLikelihood, MonteCarloEngine, batched_chi2_scan)
