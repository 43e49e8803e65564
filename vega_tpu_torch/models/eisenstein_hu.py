"""Analytic Eisenstein & Hu (1998) linear power spectrum with the
wiggle / no-wiggle decomposition.

The reference ships CAMB-generated fiducial templates (PK / PKSB columns;
reference: vega/models/*, read at vega_interface.py:666-703) and an
offline CAMB tool to make new ones (reference: bin/make_template.py).
CAMB is not a runtime dependency here; this module provides a fully
analytic physical template (EH98 transfer function, ApJ 496, 605,
eqs. 2-31) so the framework is self-contained for tests, demos and
forecasts. Production fits should still use a Boltzmann-code template
via scripts/make_template.py.

A copy of vega_tpu/models/eisenstein_hu.py (numpy only), pinned to it by
tests/test_torch_host.py.
"""

from __future__ import annotations

import numpy as np

from ..cosmo import growth_function
from ..io.fits import write_fits

# numpy >= 2 renamed trapz to trapezoid
_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def _t0_fit(q, alpha_c, beta_c):
    """EH98 eq. 19-20: the pressureless transfer-function fit."""
    c_val = 14.2 / alpha_c + 386.0 / (1 + 69.9 * q ** 1.08)
    log_term = np.log(np.e + 1.8 * beta_c * q)
    return log_term / (log_term + c_val * q * q)


def eh98_transfer(k_hmpc, h=0.674, omega_m=0.315, omega_b=0.0493,
                  t_cmb=2.7255):
    """Full EH98 transfer function with baryon acoustic oscillations.

    Parameters
    ----------
    k_hmpc : array
        Wavenumbers in h/Mpc.

    Returns
    -------
    array
        T(k), normalized to 1 at k -> 0.
    """
    k = np.asarray(k_hmpc) * h  # 1/Mpc
    om_h2 = omega_m * h * h
    ob_h2 = omega_b * h * h
    oc_h2 = om_h2 - ob_h2
    f_b = omega_b / omega_m
    f_c = 1.0 - f_b
    theta = t_cmb / 2.7

    z_eq = 2.50e4 * om_h2 * theta ** -4
    k_eq = 7.46e-2 * om_h2 * theta ** -2  # 1/Mpc

    b1 = 0.313 * om_h2 ** -0.419 * (1 + 0.607 * om_h2 ** 0.674)
    b2 = 0.238 * om_h2 ** 0.223
    z_d = (1291.0 * om_h2 ** 0.251 / (1 + 0.659 * om_h2 ** 0.828)
           * (1 + b1 * ob_h2 ** b2))

    def photon_baryon_ratio(z):
        return 31.5 * ob_h2 * theta ** -4 * (z / 1e3) ** -1

    r_d = photon_baryon_ratio(z_d)
    r_eq = photon_baryon_ratio(z_eq)

    sound_horizon = (2.0 / (3.0 * k_eq)) * np.sqrt(6.0 / r_eq) * np.log(
        (np.sqrt(1 + r_d) + np.sqrt(r_d + r_eq)) / (1 + np.sqrt(r_eq)))

    k_silk = (1.6 * ob_h2 ** 0.52 * om_h2 ** 0.73
              * (1 + (10.4 * om_h2) ** -0.95))

    q = k / (13.41 * k_eq)

    # CDM sector (eqs. 9-12, 17-18)
    a1 = (46.9 * om_h2) ** 0.670 * (1 + (32.1 * om_h2) ** -0.532)
    a2 = (12.0 * om_h2) ** 0.424 * (1 + (45.0 * om_h2) ** -0.582)
    alpha_c = a1 ** (-f_b) * a2 ** (-f_b ** 3)
    bb1 = 0.944 / (1 + (458.0 * om_h2) ** -0.708)
    bb2 = (0.395 * om_h2) ** -0.0266
    beta_c = 1.0 / (1 + bb1 * (f_c ** bb2 - 1))

    f_mix = 1.0 / (1 + (k * sound_horizon / 5.4) ** 4)
    t_c = (f_mix * _t0_fit(q, 1.0, beta_c)
           + (1 - f_mix) * _t0_fit(q, alpha_c, beta_c))

    # Baryon sector (eqs. 13-16, 21-24)
    y = (1 + z_eq) / (1 + z_d)
    sqrt_1py = np.sqrt(1 + y)
    g_y = y * (-6 * sqrt_1py
               + (2 + 3 * y) * np.log((sqrt_1py + 1) / (sqrt_1py - 1)))
    alpha_b = 2.07 * k_eq * sound_horizon * (1 + r_d) ** -0.75 * g_y
    beta_b = 0.5 + f_b + (3 - 2 * f_b) * np.sqrt((17.2 * om_h2) ** 2 + 1)
    beta_node = 8.41 * om_h2 ** 0.435
    ks = k * sound_horizon
    s_tilde = sound_horizon / (1 + (beta_node / ks) ** 3) ** (1.0 / 3)

    x = k * s_tilde
    sinc = np.ones_like(x)
    nz = x != 0
    sinc[nz] = np.sin(x[nz]) / x[nz]
    t_b = (_t0_fit(q, 1.0, 1.0) / (1 + (ks / 5.2) ** 2)
           + alpha_b / (1 + (beta_b / ks) ** 3)
           * np.exp(-(k / k_silk) ** 1.4)) * sinc

    return f_b * t_b + f_c * t_c


def eh98_transfer_nowiggle(k_hmpc, h=0.674, omega_m=0.315, omega_b=0.0493,
                           t_cmb=2.7255):
    """EH98 no-wiggle (smooth) transfer function (eqs. 28-31)."""
    k = np.asarray(k_hmpc) * h  # 1/Mpc
    om_h2 = omega_m * h * h
    ob_h2 = omega_b * h * h
    f_b = omega_b / omega_m
    theta = t_cmb / 2.7

    # eq. 26: approximate sound horizon
    s_approx = (44.5 * np.log(9.83 / om_h2)
                / np.sqrt(1 + 10 * ob_h2 ** 0.75))

    alpha_gamma = (1 - 0.328 * np.log(431.0 * om_h2) * f_b
                   + 0.38 * np.log(22.3 * om_h2) * f_b ** 2)
    gamma_eff = omega_m * h * (
        alpha_gamma + (1 - alpha_gamma) / (1 + (0.43 * k * s_approx) ** 4))

    q = np.asarray(k_hmpc) * theta ** 2 / gamma_eff
    log_term = np.log(2 * np.e + 1.8 * q)
    c_val = 14.2 + 731.0 / (1 + 62.5 * q)
    return log_term / (log_term + c_val * q * q)


def _sigma_r(k, pk, r=8.0):
    """sigma(R) from a sampled P(k) via trapezoidal integration."""
    x = k * r
    w = np.ones_like(x)
    nz = x > 1e-8
    w[nz] = 3 * (np.sin(x[nz]) - x[nz] * np.cos(x[nz])) / x[nz] ** 3
    integrand = k ** 2 * pk * w ** 2 / (2 * np.pi ** 2)
    return np.sqrt(_trapezoid(integrand, k))


def make_fiducial_template(path=None, z_ref=2.3, h=0.674, omega_m=0.315,
                           omega_b=0.0493, n_s=0.965, sigma8=0.811,
                           k_min=1e-4, k_max=1152.5, n_k=814):
    """Build a fiducial Pk FITS template (K / PK / PKSB columns with
    ZREF / OM / OL / F_ZREF headers) analytically.

    Same file layout as the shipped CAMB templates the reference reads
    (vega_interface.py:666-703).
    """
    k = np.logspace(np.log10(k_min), np.log10(k_max), n_k)

    t_full = eh98_transfer(k, h, omega_m, omega_b)
    t_smooth = eh98_transfer_nowiggle(k, h, omega_m, omega_b)

    pk_shape = k ** n_s * t_full ** 2
    amp = (sigma8 / _sigma_r(k, pk_shape)) ** 2
    pk_full_z0 = amp * pk_shape
    pk_smooth_z0 = amp * k ** n_s * t_smooth ** 2

    omega_de = 1.0 - omega_m
    growth_ratio = (growth_function(z_ref, omega_m, omega_de)
                    / growth_function(0.0, omega_m, omega_de))
    pk_full = pk_full_z0 * growth_ratio ** 2
    pk_smooth = pk_smooth_z0 * growth_ratio ** 2

    # Logarithmic growth rate f = dlnD/dlna at z_ref
    dz = 1e-4
    d_hi = growth_function(z_ref + dz, omega_m, omega_de)
    d_lo = growth_function(z_ref - dz, omega_m, omega_de)
    dlnd_dz = (np.log(d_hi) - np.log(d_lo)) / (2 * dz)
    f_zref = -(1 + z_ref) * dlnd_dz

    header = {'ZREF': z_ref, 'OM': omega_m, 'OL': omega_de,
              'F_ZREF': float(f_zref)}
    hdus = [{'name': 'PK', 'header': header,
             'columns': {'K': k, 'PK': pk_full, 'PKSB': pk_smooth}}]
    if path is not None:
        write_fits(path, hdus)
    return k, pk_full, pk_smooth, header
