"""rt-slice wedges. A copy of vega_tpu/plots/rt_wedges.py."""

from __future__ import annotations

import numpy as np

from .wedges import Wedge, bin_centers


class RtWedge(Wedge):
    """Perpendicular-distance slice of a 2D correlation
    (reference: plots/rt_wedges.py:6-57)."""

    def __init__(self, rp=(0., 200., 50), rt=(0., 200., 50),
                 rt_cut=(0., 4.0)):
        rp_bins = np.linspace(rp[0], rp[1], rp[2] + 1)
        rt_bins = np.linspace(rt[0], rt[1], rt[2] + 1)
        rp_centers = bin_centers(rp_bins)
        rt_centers = bin_centers(rt_bins)

        rt_mesh, rp_mesh = np.meshgrid(rt_centers, rp_centers)
        rt_idx = np.digitize(rt_mesh, rt_bins) - 1
        rp_idx = np.digitize(rp_mesh, rp_bins) - 1

        bins = rt_idx + rt[2] * rp_idx + rt[2] * rp[2] * rp_idx
        mask = (rt_mesh > rt_cut[0]) & (rt_mesh < rt_cut[1])

        counts = np.bincount(bins[mask].flatten())
        positive_idx = np.where(counts != 0)
        self.weights = np.zeros((rp[2], rt[2] * rp[2]))
        weights_idx = np.unravel_index(positive_idx, self.weights.shape)
        self.weights[weights_idx] = counts[positive_idx]
        self.r = rp_centers
