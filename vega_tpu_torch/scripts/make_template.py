#!/usr/bin/env python
"""Fiducial-template generator (offline tool).

    python -m vega_tpu_torch.scripts.make_template -o template.fits

A copy of vega_tpu/scripts/make_template.py on the port's own FFTLog
(`ops/fftlog.py`) and Eisenstein-Hu spectrum (`models/eisenstein_hu.py`),
host numpy only: the same arguments write the same file
(tests/test_torch_config_tools.py). Counterpart of the reference's
bin/make_template.py: compute a linear
P(k) at z_ref, decompose it into peak + side-band (smooth) components
following section 2.2.1 of Kirkby et al. 2013 (arXiv:1301.3456), and
write the K/PK/PKSB template FITS.

The Boltzmann P(k) comes from CAMB when installed (same configuration
surface as the reference); without CAMB the analytic Eisenstein-Hu
spectrum is used (vega_tpu_torch.models.eisenstein_hu), which is adequate for
mocks and forecasts but not for production fits.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy.interpolate import InterpolatedUnivariateSpline
from scipy.optimize import curve_fit

from vega_tpu_torch.io.fits import write_fits
from vega_tpu_torch.ops.fftlog import (
    FFTLogP2Xi, FFTLogXi2P, extrapolated_transform)

K_MIN, K_MAX, N_POINTS = 1.e-4, 1.1525e3, 814


def sideband_decompose(k, pk, h=0.674, rdrag=147.3, extrap=True):
    """Kirkby et al. 2013 side-band split: fit a power-law-series model to
    xi(r) outside the BAO feature, replace the peak region, and transform
    back (reference: bin/make_template.py:111-152).
    """
    coef = (h * 100. / 67.31) * (rdrag / 147.334271564563)
    sb1_rmin, sb1_rmax = 50. * coef, 82. * coef
    sb2_rmin, sb2_rmax = 150. * coef, 190. * coef

    # Forward transform with padding so the xi spline covers the full
    # working r range [1e-7, 10^3.5] without extrapolating
    r_fwd, xi_fwd = extrapolated_transform(FFTLogP2Xi, k, pk,
                                           pad_factor=4, keep='all')
    xi_spline = InterpolatedUnivariateSpline(r_fwd, xi_fwd)
    r = np.logspace(-7., 3.5, 10000)
    xi = xi_spline(r)

    def f_xi_sb(rr, am3, am2, am1, a0, a1):
        par = [am3, am2, am1, a0, a1]
        model = np.zeros((len(par), rr.size))
        tw = rr != 0.
        model[0, tw] = par[0] / rr[tw] ** 3
        model[1, tw] = par[1] / rr[tw] ** 2
        model[2, tw] = par[2] / rr[tw]
        model[3, tw] = par[3]
        model[4, :] = par[4] * rr
        return model.sum(axis=0)

    w = (((r >= sb1_rmin) & (r < sb1_rmax))
         | ((r >= sb2_rmin) & (r < sb2_rmax)))
    sigma = 0.1 * np.ones(xi.size)
    sigma[(r >= sb1_rmin - 2.) & (r < sb1_rmin + 2.)] = 1.e-6
    sigma[(r >= sb2_rmax - 2.) & (r < sb2_rmax + 2.)] = 1.e-6
    popt, _ = curve_fit(f_xi_sb, r[w], xi[w], sigma=sigma[w])

    xi_sb = xi.copy()
    ww = (r >= sb1_rmin) & (r < sb2_rmax)
    xi_sb[ww] = f_xi_sb(r, *popt)[ww]

    if extrap:
        k_out, pk_sb = extrapolated_transform(FFTLogXi2P, r, xi_sb)
    else:
        inv = FFTLogXi2P(r, 0)
        k_out, pk_sb = inv.k_grid, inv.transform(xi_sb)
    pk_sb_spline = InterpolatedUnivariateSpline(k_out, pk_sb)
    pk_sb = pk_sb_spline(k)
    pk_sb *= pk[-1] / pk_sb[-1]
    return pk_sb


def make_template_camb(ini, z_ref=None, fid_H0=None, fid_Ok=None,
                       fid_wl=None, extrap=True):
    """CAMB path (reference: bin/make_template.py:32-109)."""
    import camb
    import os

    pars = camb.read_ini(os.path.expandvars(ini))
    pars.Transfer.kmax = K_MAX
    if z_ref is not None:
        pars.Transfer.PK_redshifts[0] = z_ref
    if fid_H0 is not None:
        pars.H0 = fid_H0
    if fid_Ok is not None:
        pars.omk = fid_Ok
    if fid_wl is not None:
        pars.DarkEnergy.w = fid_wl

    results = camb.get_results(pars)
    k, _, pk = results.get_matter_power_spectrum(
        minkh=K_MIN, maxkh=pars.Transfer.kmax, npoints=N_POINTS)
    pk = pk[1]
    pars = results.Params
    pars2 = results.get_derived_params()

    h = pars.H0 / 100.
    header = {
        'H0': pars.H0,
        'OMBH2': pars.ombh2, 'OMCH2': pars.omch2, 'OMNUH2': pars.omnuh2,
        'NS': pars.InitPower.ns, 'OK': pars.omk,
        'OL': results.get_Omega('de'),
        'OM': (pars.ombh2 + pars.omch2 + pars.omnuh2) / h ** 2,
        'W': pars.DarkEnergy.w,
        'TCMB': pars.TCMB,
        'ZREF': pars.Transfer.PK_redshifts[0],
        'SIGMA8': results.get_sigma8()[0],
        'F_ZREF': (results.get_fsigma8()[0] / results.get_sigma8()[0]),
        'ZDRAG': pars2['zdrag'], 'RDRAG': pars2['rdrag'],
    }
    pk_sb = sideband_decompose(k, pk, h=h, rdrag=pars2['rdrag'],
                               extrap=extrap)
    return k, pk, pk_sb, header


def make_template_eh98(z_ref=2.3, h=0.674, omega_m=0.315, omega_b=0.0493,
                       n_s=0.965, sigma8=0.811, extrap=True):
    """Analytic fallback: EH98 spectrum with the same Kirkby side-band
    decomposition applied for PKSB (instead of the EH98 no-wiggle form,
    for consistency with CAMB-made templates)."""
    from vega_tpu_torch.models.eisenstein_hu import make_fiducial_template

    k, pk, _, header = make_fiducial_template(
        None, z_ref=z_ref, h=h, omega_m=omega_m, omega_b=omega_b, n_s=n_s,
        sigma8=sigma8, k_min=K_MIN, k_max=K_MAX, n_k=N_POINTS)
    pk_sb = sideband_decompose(k, pk, h=h, extrap=extrap)
    return k, pk, pk_sb, header


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-i', '--ini', type=str, default=None,
                        help='CAMB config file (omit for the EH98 path)')
    parser.add_argument('-o', '--out', type=str, required=True)
    parser.add_argument('--fid-H0', type=float, default=None)
    parser.add_argument('--fid-Ok', type=float, default=None)
    parser.add_argument('--fid-wl', type=float, default=None)
    parser.add_argument('--z-ref', type=float, default=None)
    parser.add_argument('--no-extrap', action='store_true')
    parser.add_argument('--omega-m', type=float, default=0.315,
                        help='EH98 path only')
    parser.add_argument('--sigma8', type=float, default=0.811,
                        help='EH98 path only')
    args = parser.parse_args(argv)

    extrap = not args.no_extrap
    if args.ini is not None:
        try:
            k, pk, pk_sb, header = make_template_camb(
                args.ini, args.z_ref, args.fid_H0, args.fid_Ok,
                args.fid_wl, extrap)
        except ImportError:
            print('CAMB is not installed; falling back to the analytic '
                  'EH98 template (NOT for production fits).')
            k, pk, pk_sb, header = make_template_eh98(
                z_ref=args.z_ref or 2.3, omega_m=args.omega_m,
                sigma8=args.sigma8, extrap=extrap)
    else:
        k, pk, pk_sb, header = make_template_eh98(
            z_ref=args.z_ref or 2.3, omega_m=args.omega_m,
            sigma8=args.sigma8, extrap=extrap)

    write_fits(args.out, [{
        'name': 'PK', 'header': header,
        'columns': {'K': k, 'PK': pk, 'PKSB': pk_sb}}])
    print(f'Wrote template to {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
