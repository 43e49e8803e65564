"""Row-sharded global-covariance quadratic form (counterpart of
vega_tpu/parallel/global_cov.py).

A joint fit compares the concatenated correlations with one global
covariance. For joint vectors of O(10^4-10^5) bins the (N, N) f64
inverse (0.8 GB at N = 10^4, 80 GB at N = 10^5) must be split over
devices. Its rows are padded with zero rows and columns to a multiple of
the mesh size and placed one row block per mesh entry; then

    chi^2 = diff' C^-1 diff = sum over blocks of diff_block' (C_block diff)

with each block's product on its device (plain f64 GEMMs, as vega_tpu's
are plain XLA products outside any Pallas kernel) and the partial sums
added on the first entry's device. Over several processes each adds its
own blocks and the partial sums are all-reduced (gloo).
"""

from __future__ import annotations

import numpy as np
import torch

from .batch import make_device_mesh


class ShardedGlobalChi2:
    """Row-sharded chi^2 = diff' C^-1 diff over a device mesh, in f64.

    Rows are padded with zeros to a multiple of the mesh size (zero rows
    contribute nothing to the quadratic form)."""

    def __init__(self, global_invcov, mesh=None, axis_name='shard'):
        invcov = np.asarray(global_invcov, dtype=np.float64)
        if invcov.ndim != 2 or invcov.shape[0] != invcov.shape[1]:
            raise ValueError(f'a square inverse covariance, got '
                             f'{invcov.shape}')
        self.n = invcov.shape[0]
        self.mesh = mesh if mesh is not None else make_device_mesh(
            axis_name=axis_name)
        self.axis_name = self.mesh.axis_names[0]
        n_dev = self.mesh.size
        self._pad = (-self.n) % n_dev
        if self._pad:
            invcov = np.pad(invcov, ((0, self._pad), (0, self._pad)))
        self.block_rows = invcov.shape[0] // n_dev
        # this process's row blocks, each on its device; columns stay full
        self._blocks = [
            (entry, torch.as_tensor(
                invcov[entry * self.block_rows:
                       (entry + 1) * self.block_rows],
                device=self.mesh.devices[entry]))
            for entry in self.mesh.local_entries]
        self.device = self._blocks[0][1].device

    def _partial(self, diffs):
        """sum over this process's blocks of diff_block' (C_block diff),
        diffs (B, n + pad) f64; (B,) on self.device, every block's product
        issued before any is added."""
        parts = []
        for entry, block in self._blocks:
            d = diffs.to(block.device)
            rows = d[:, entry * self.block_rows:
                     (entry + 1) * self.block_rows]
            parts.append(torch.sum(rows * (d @ block.T), dim=-1))
        out = sum(p.to(self.device) for p in parts)
        if self.mesh.spans_processes:
            import torch.distributed as dist
            host = out.cpu()
            dist.all_reduce(host)
            out = host.to(self.device)
        return out

    def _padded(self, diffs):
        diffs = torch.as_tensor(diffs, dtype=torch.float64)
        if self._pad:
            diffs = torch.nn.functional.pad(diffs, (0, self._pad))
        return diffs

    def chi2(self, diff):
        """diff: (n,) -> 0-d f64 tensor."""
        diff = torch.as_tensor(diff, dtype=torch.float64)
        if tuple(diff.shape) != (self.n,):
            raise ValueError(f'diff of shape ({self.n},), got '
                             f'{tuple(diff.shape)}')
        return self._partial(self._padded(diff[None]))[0]

    def chi2_batch(self, diffs):
        """diffs: (B, n) -> (B,) f64 tensor."""
        diffs = torch.as_tensor(diffs, dtype=torch.float64)
        if diffs.dim() != 2 or diffs.shape[1] != self.n:
            raise ValueError(f'diffs of shape (B, {self.n}), got '
                             f'{tuple(diffs.shape)}')
        return self._partial(self._padded(diffs))
