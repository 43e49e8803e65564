"""The host constants of a VegaInterface as named numpy arrays.

The names are the JAX package's attribute names, so a test can build the
dict from a `vega_tpu.VegaInterface`, hold the port's own init against it
and then install it in the port (`load_constants`), which makes the
comparison of outputs independent of init.

Keys: '<correlation name>/<attribute>' for the per-correlation constants
of `PER_CORRELATION`, the bare names of `FIDUCIAL`, and for a correlation
with a stacked metal plan '<correlation name>/metals/<class index>/<name>'
for each class's plan arrays (`metals.PLAN_CONSTANTS`: coordinates,
growth, rel_z, moment_proj) and its representative pair's constants
(`METAL_REPRESENTATIVE`). The metal matrices are data: both packages read
them from the metal file.
"""

from __future__ import annotations

import numpy as np

from .metals import PLAN_CONSTANTS

# attribute -> the object of a correlation that carries it
PER_CORRELATION = {
    'fft_ops': 'pktoxi', 'fft_sd_ops': 'pktoxi', 'logr_knots': 'pktoxi',
    'legendre_proj': 'pktoxi',
    'k_par_grid': 'power_spectrum', 'k_trans_grid': 'power_spectrum',
    'pk_Gk': 'power_spectrum',
    'xi_growth': 'correlation_func', '_rel_z_evol': 'correlation_func',
    'inv_masked_cov': 'data', 'masked_data_vec': 'data',
    'data_mask': 'data', 'model_mask': 'data',
}
FIDUCIAL = ('pk_full', 'pk_smooth')
# attribute -> the object of a metal class's plan that carries it
METAL_REPRESENTATIVE = {
    'fft_ops': 'pktoxi_rep', 'fft_sd_ops': 'pktoxi_rep',
    'logr_knots': 'pktoxi_rep', 'legendre_proj': 'pktoxi_rep',
    'k_par_grid': 'pk_rep', 'k_trans_grid': 'pk_rep', 'pk_Gk': 'pk_rep',
}


def _host(x):
    if hasattr(x, 'detach'):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def export_constants(interface):
    """The port's host constants, keyed as `load_constants` takes them."""
    out = {name: np.asarray(interface.fiducial[name]) for name in FIDUCIAL}
    for corr, model in interface.models.items():
        owners = {'pktoxi': model.PktoXi, 'power_spectrum': model.Pk_core,
                  'correlation_func': model.Xi_core,
                  'data': interface.data[corr]}
        for attr, owner in PER_CORRELATION.items():
            out[f'{corr}/{attr}'] = _host(getattr(owners[owner], attr))
        for i, plan in enumerate(_metal_plans(model)):
            for name in PLAN_CONSTANTS:
                out[f'{corr}/metals/{i}/{name}'] = _host(plan[name])
            for attr, owner in METAL_REPRESENTATIVE.items():
                out[f'{corr}/metals/{i}/{attr}'] = _host(
                    getattr(plan[owner], attr))
    return out


def _metal_plans(model):
    """The stacked metal classes of a port Model ([] without metals or
    without a plan)."""
    if model.metals is None:
        return []
    return model.metals._stacked_plans or []


def metal_keys(interface):
    """The metal keys `load_constants` needs for this interface."""
    return {f'{corr}/metals/{i}/{name}'
            for corr, model in interface.models.items()
            for i in range(len(_metal_plans(model)))
            for name in PLAN_CONSTANTS + tuple(METAL_REPRESENTATIVE)}


def load_constants(interface, arrays):
    """Set the port's host constants (and their device copies) from numpy
    arrays named after the JAX attributes; every key must be present."""
    missing = ({f'{c}/{a}' for c in interface.models for a in PER_CORRELATION}
               | set(FIDUCIAL) | metal_keys(interface)) - set(arrays)
    if missing:
        raise KeyError(f'missing constants: {sorted(missing)}')
    interface.set_fiducial_pk(arrays['pk_full'], arrays['pk_smooth'])
    for corr, model in interface.models.items():
        a = {attr: np.asarray(arrays[f'{corr}/{attr}'])
             for attr in PER_CORRELATION}
        model.PktoXi.set_constants(
            legendre_proj=a['legendre_proj'], fft_ops=a['fft_ops'],
            fft_sd_ops=a['fft_sd_ops'], logr_knots=a['logr_knots'])
        model.Pk_core.set_constants(a['k_par_grid'], a['k_trans_grid'],
                                    a['pk_Gk'])
        model.Xi_core.set_constants(xi_growth=a['xi_growth'],
                                    rel_z_evol=a['_rel_z_evol'])
        data = interface.data[corr]
        data.data_mask = a['data_mask'].astype(bool)
        data.model_mask = a['model_mask'].astype(bool)
        data.masked_data_vec = a['masked_data_vec']
        data._inv_masked_cov = a['inv_masked_cov']
        plans = _metal_plans(model)
        for i, plan in enumerate(plans):
            m = {name: np.asarray(arrays[f'{corr}/metals/{i}/{name}'])
                 for name in PLAN_CONSTANTS + tuple(METAL_REPRESENTATIVE)}
            plan['pktoxi_rep'].set_constants(
                legendre_proj=m['legendre_proj'], fft_ops=m['fft_ops'],
                fft_sd_ops=m['fft_sd_ops'], logr_knots=m['logr_knots'])
            plan['pk_rep'].set_constants(m['k_par_grid'], m['k_trans_grid'],
                                         m['pk_Gk'])
        if plans:
            model.metals.set_plan_constants([
                {name: np.asarray(arrays[f'{corr}/metals/{i}/{name}'])
                 for name in PLAN_CONSTANTS} for i in range(len(plans))])
    interface.set_chi2_constants()
