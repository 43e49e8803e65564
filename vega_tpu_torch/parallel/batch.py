"""Batched likelihood evaluation on one GPU.

Counterpart of vega_tpu/parallel/batch.py's `BatchedLikelihood`
(:44-196) for one device: the batch runs in row chunks on the
interface's device, with the collapse or grid payload resident there
(VegaInterface caches its device copy). Sharding over several cards,
`traceable_log_lik` (for the samplers) and the Monte-Carlo engine are
not ported yet.
"""

from __future__ import annotations


class BatchedLikelihood:
    """chi^2 / log-likelihood over parameter batches ({name: (B,)
    values}) of one VegaInterface.

    chunk_rows bounds the rows in flight at once; None takes the
    interface's default for the path the names select."""

    def __init__(self, vega, chunk_rows=None):
        if chunk_rows is not None and int(chunk_rows) < 1:
            raise ValueError(f'chunk_rows must be positive, got {chunk_rows}')
        self.vega = vega
        self.chunk_rows = None if chunk_rows is None else int(chunk_rows)

    def chi2(self, param_batches):
        """(B,) f64 tensor on the interface's device."""
        return self.vega.chi2_batch(param_batches,
                                    chunk_rows=self.chunk_rows)

    def log_lik(self, param_batches):
        return self.vega.log_lik_batch(param_batches,
                                       chunk_rows=self.chunk_rows)
