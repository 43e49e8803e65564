"""Coordinate grids for correlation-function bins.

Host-side (numpy) equivalent of the reference's vega/coordinates.py: all
grids and masks are static per config, computed once at init, then copied
to the device as tensors. A copy of vega_tpu/coordinates.py (the JAX
package cannot be imported where JAX is absent), pinned to it by the
equality tests in tests/test_torch_host.py.
"""

from __future__ import annotations

import numpy as np


class Coordinates:
    """(rp, rt, z) grids and derived (r, mu), plus scale-cut masks
    (reference: coordinates.py:8-217, same semantics)."""

    def __init__(self, rp_min, rp_max, rt_max, rp_nbins, rt_nbins,
                 rp_grid=None, rt_grid=None, z_grid=None, z_eff=None,
                 r_grid=None, mu_grid=None):
        self.rp_min = rp_min
        self.rp_max = rp_max
        self.rt_max = rt_max
        self.rp_nbins = rp_nbins
        self.rt_nbins = rt_nbins

        self.rp_binsize = (rp_max - rp_min) / rp_nbins
        self.rt_binsize = rt_max / rt_nbins

        rp_regular = np.arange(rp_min + self.rp_binsize / 2, rp_max,
                               self.rp_binsize)
        rt_regular = np.arange(self.rt_binsize / 2, rt_max, self.rt_binsize)
        rt_mesh, rp_mesh = np.meshgrid(rt_regular, rp_regular)
        self.rp_regular_grid = rp_mesh.flatten()
        self.rt_regular_grid = rt_mesh.flatten()

        self.rp_grid = self.rp_regular_grid if rp_grid is None else np.asarray(rp_grid)
        self.rt_grid = self.rt_regular_grid if rt_grid is None else np.asarray(rt_grid)

        if r_grid is None:
            self.r_grid = np.sqrt(self.rp_grid ** 2 + self.rt_grid ** 2)
        else:
            self.r_grid = np.asarray(r_grid)
        self.r_regular_grid = np.sqrt(
            self.rp_regular_grid ** 2 + self.rt_regular_grid ** 2)

        if mu_grid is None:
            self.mu_grid = np.zeros_like(self.r_grid)
            w = self.r_grid > 0
            self.mu_grid[w] = self.rp_grid[w] / self.r_grid[w]
        else:
            self.mu_grid = np.asarray(mu_grid)

        self.mu_regular_grid = np.zeros_like(self.r_regular_grid)
        w = self.r_regular_grid > 0
        self.mu_regular_grid[w] = self.rp_regular_grid[w] / self.r_regular_grid[w]

        if z_grid is None and z_eff is None:
            self.z_grid = None
        else:
            self.z_grid = z_eff if z_grid is None else np.asarray(z_grid)

    @classmethod
    def init_from_grids(cls, other, rp_grid, rt_grid, z_grid):
        return cls(other.rp_min, other.rp_max, other.rt_max,
                   other.rp_nbins, other.rt_nbins,
                   rp_grid=rp_grid, rt_grid=rt_grid, z_grid=z_grid)

    @classmethod
    def init_from_r_mu_grids(cls, r_grid, mu_grid, z_eff=None):
        r_grid = np.asarray(r_grid)
        mu_grid = np.asarray(mu_grid)
        if len(r_grid) != len(mu_grid):
            raise ValueError('r_grid and mu_grid must have the same size')
        rp_grid = r_grid * mu_grid
        rt_grid = r_grid * np.sqrt(1 - mu_grid ** 2)
        return cls(rp_min=rp_grid.min(), rp_max=rp_grid.max(),
                   rt_max=rt_grid.max(), rp_nbins=len(r_grid),
                   rt_nbins=len(r_grid), rp_grid=rp_grid, rt_grid=rt_grid,
                   r_grid=r_grid, mu_grid=mu_grid, z_eff=z_eff)

    def get_mask_to_other(self, other):
        """Mask from this grid onto another grid with identical bin sizes
        (reference: coordinates.py:127-144)."""
        assert self.rp_binsize == other.rp_binsize
        assert self.rt_binsize == other.rt_binsize
        mask = (self.rp_grid >= other.rp_min) & (self.rp_grid <= other.rp_max)
        mask &= self.rt_grid <= other.rt_max
        return mask

    def get_mask_scale_cuts(self, cuts_config, small_scale_mask=False):
        """Scale-cut mask on the regular grid (reference:
        coordinates.py:146-182; defaults identical)."""
        rp_min_cut = cuts_config.getfloat('rp-min', 0.)
        rp_max_cut = cuts_config.getfloat('rp-max', 300.)
        rt_min_cut = cuts_config.getfloat('rt-min', 0.)
        rt_max_cut = cuts_config.getfloat('rt-max', 300.)
        r_min_cut = cuts_config.getfloat('r-min', 10.)
        r_max_cut = cuts_config.getfloat('r-max', 180.)
        mu_min_cut = cuts_config.getfloat('mu-min', -1.)
        mu_max_cut = cuts_config.getfloat('mu-max', +1.)

        mask = (self.rp_regular_grid > rp_min_cut)
        mask &= (self.rt_regular_grid > rt_min_cut)
        mask &= (self.r_regular_grid > r_min_cut)
        if small_scale_mask:
            return mask
        mask &= (self.rp_regular_grid < rp_max_cut)
        mask &= (self.rt_regular_grid < rt_max_cut)
        mask &= (self.r_regular_grid < r_max_cut)
        mask &= (self.mu_regular_grid > mu_min_cut)
        mask &= (self.mu_regular_grid < mu_max_cut)
        return mask

    def get_mask_marginalization_scales(self, cuts_config, marginalization_cuts):
        """Mask of marginalized bins (reference: coordinates.py:184-217)."""
        mask = np.ones_like(self.rp_regular_grid, dtype=bool)
        if 'rtmax' in marginalization_cuts:
            mask &= self.rt_regular_grid < marginalization_cuts['rtmax']
        if 'rtmin' in marginalization_cuts:
            mask &= self.rt_regular_grid > marginalization_cuts['rtmin']
        if 'rpmax' in marginalization_cuts:
            mask &= np.abs(self.rp_regular_grid) < marginalization_cuts['rpmax']
        if 'rpmin' in marginalization_cuts:
            mask &= np.abs(self.rp_regular_grid) > marginalization_cuts['rpmin']
        if 'all-rmin' in marginalization_cuts:
            mask = ~self.get_mask_scale_cuts(cuts_config, small_scale_mask=True)
        return mask
