from vega_tpu_torch.parallel.batch import (  # noqa: F401
    BatchedLikelihood, DeviceMesh, MonteCarloEngine, batched_chi2_scan,
    make_device_mesh)
from vega_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh, initialize, local_batch_slice)
from vega_tpu_torch.parallel.global_cov import ShardedGlobalChi2  # noqa: F401
