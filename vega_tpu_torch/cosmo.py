"""Internal cosmology: growth factor and comoving distances.

Replaces two native/external dependencies of the reference:
- numba-jitted growth machinery (reference: utils.py:128-227)
- picca.constants.Cosmo used for cross-correlation redshift splitting and
  new-metals distortion matrices (reference: correlation_item.py:138-151,
  metals.py:469-470)

All of this is init-time host work (the growth factor enters the model
only as a precomputed array), so it stays numpy/scipy. A copy of
vega_tpu/cosmo.py, pinned to it by the equality tests in
tests/test_torch_host.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.integrate import quad
from scipy.interpolate import interp1d

SPEED_OF_LIGHT = 299792.458  # km/s


def hubble(z, omega_m, omega_de):
    """Dimensionless Hubble parameter E(z) in LCDM + curvature
    (reference: utils.py:128-149; no radiation/neutrinos)."""
    omega_k = 1 - omega_m - omega_de
    return np.sqrt(omega_m * (1 + z) ** 3 + omega_de + omega_k * (1 + z) ** 2)


def growth_integrand(a, omega_m, omega_de):
    """Integrand for the growth factor (reference: utils.py:152-172)."""
    z = 1 / a - 1
    return 1.0 / (a * hubble(z, omega_m, omega_de)) ** 3


@lru_cache(maxsize=32)
def get_growth_interp(omega_m, omega_de):
    """Cubic interpolation of D(z) on z in [0, 10]
    (reference: utils.py:175-205, identical grid and quadrature)."""
    z_grid = np.linspace(0, 10, 1000)
    growth = np.zeros(1000)
    for i, z in enumerate(z_grid):
        a = 1 / (1 + z)
        growth_int = quad(growth_integrand, 0, a, args=(omega_m, omega_de))[0]
        growth[i] = 2.5 * omega_m * hubble(z, omega_m, omega_de) * growth_int
    return interp1d(z_grid, growth, kind='cubic')


def growth_function(z, omega_m, omega_de):
    """Growth factor D(z) (reference: utils.py:208-227)."""
    return get_growth_interp(omega_m, omega_de)(z)


class Cosmo:
    """Flat-by-default FLRW cosmology with comoving-distance tables.

    API-compatible subset of picca.constants.Cosmo: get_r_comov(z) and
    get_dist_hubble(z), both in Mpc/h (H0 = 100 h km/s/Mpc convention).
    """

    def __init__(self, Om, Ok=0.0, Or=0.0, wl=-1.0, zmax=12.0, nbins=10000):
        self.Om, self.Ok, self.Or, self.wl = Om, Ok, Or, wl
        Ol = 1.0 - Om - Ok - Or
        self.Ol = Ol

        z = np.linspace(0.0, zmax, nbins)
        e_z = np.sqrt(
            Om * (1 + z) ** 3 + Or * (1 + z) ** 4 + Ok * (1 + z) ** 2
            + Ol * (1 + z) ** (3 * (1 + wl))
        )
        self._e_of_z = interp1d(z, e_z, kind='cubic')
        # D_C(z) = c/H0 * int dz / E(z); H0 = 100 h -> units of Mpc/h
        hubble_dist = SPEED_OF_LIGHT / 100.0
        integrand = hubble_dist / e_z
        r_comov = np.concatenate(
            [[0.0], np.cumsum((integrand[1:] + integrand[:-1]) / 2 * np.diff(z))])
        self._r_comov = interp1d(z, r_comov, kind='cubic')

    def get_r_comov(self, z):
        """Comoving distance D_C(z) in Mpc/h."""
        return self._r_comov(np.asarray(z, dtype=float))

    def get_dist_hubble(self, z):
        """Hubble distance D_H(z) = c / H(z) in Mpc/h."""
        return (SPEED_OF_LIGHT / 100.0) / self._e_of_z(np.asarray(z, dtype=float))


# Rest-frame wavelengths (Angstrom) of the absorbers handled by the
# framework; used by the new-metals distortion-matrix machinery
# (reference uses picca.constants.ABSORBER_IGM, metals.py:523-535).
# Values from the SDSS/DESI linelists used by picca.
ABSORBER_IGM = {
    'LYA': 1215.67,
    'LYB': 1025.7223,
    'SiII(1190)': 1190.4158,
    'SiII(1193)': 1193.2897,
    'SiIII(1207)': 1206.500,
    'SiII(1260)': 1260.4221,
    'SiII(1526)': 1526.70698,
    'CIV(1548)': 1548.2049,
    'CIV(eff)': 1549.06,
    'CIV(1550)': 1550.77845,
    'MgII(2796)': 2796.3511,
    'MgII(2803)': 2803.5324,
    'FeII(2344)': 2344.2129601,
    'FeII(2374)': 2374.4603294,
    'FeII(2382)': 2382.7641781,
    'FeII(2586)': 2586.6495659,
    'FeII(2600)': 2600.1724835,
    'AlII(1670)': 1670.7886,
    'AlIII(1854)': 1854.71829,
    'AlIII(1862)': 1862.79113,
    'NV(1238)': 1238.821,
    'NV(1242)': 1242.804,
    'OI(1039)': 1039.230,
    'SiII(989)': 989.8731,
    'OVI(1031)': 1031.9261,
    'OVI(1037)': 1037.6167,
    'CIII(977)': 977.020,
    'CII(1334)': 1334.5323,
}
