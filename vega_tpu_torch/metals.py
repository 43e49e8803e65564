"""Metal-contamination correlations (legacy metal-file mode).

Counterpart of vega_tpu/metals.py:31-635. The metal pairs of one
correlation are grouped into classes whose Pk -> xi pipelines differ only
in scalars (`_plan_stacking`). Per class, the pair dependence of the
metal Pk is (1 + (b1 + b2) mu^2 + b1 b2 mu^4), so the shared (mu_k, k)
grid is projected once with three mu^(0,2,4)-weighted Legendre tables
into (3, L, N) knot tables, and each pair is a 3-term combination of
them, evaluated at that pair's own (r, mu) grid.

That last stage, a cubic spline of (rows, L, N) knot tables at per-pair
log r times Legendre summed over ell, is the spline + Legendre combine
(ops/spline_combine.py): vega_tpu leaves it to XLA (`spline_eval` +
einsum), here it is the CUDA kernel on the card, in two layouts:

- dense: rows = pairs x batch in pair-major order, one coordinate row
  per pair (row groups of the batch size); a coordinate row per row when
  a sampled drp shifts the class's coordinates;
- factored: rows = pairs x 3 moments, one coordinate row per pair (row
  groups of 3), the result a FactoredXi with coefficients
  weight x (1, b1 + b2, b1 b2) per pair.

Metals use ap = at = 1 unless `metal-scaling` is set, so in the grid
sweep their rows do not move with (ap, at); a class of the
cross-correlation moves with `drp_<discrete tracer>`.

The metal distortion matrices come from the legacy metal file, or, in
the new-metals mode (`new_metals = True`, vega_tpu/metals.py:636-914),
are computed once on the host from the stacked-delta weights files:
pair histograms of the assumed against the true line-of-sight
separation (native/pair_hist.cpp, built with g++; the numpy route only
when a caller asks for it), an rt distortion from the distance-ratio
histogram, and each pair's effective coordinates. Each pair's matrix,
built in f64 on the host and cast once to the model's dtype (f32 in the
f32 mode, with TF32 off), is then applied after the combine: the full
(rp x rt) matrix as one GEMM (xi @ D^T), or with `rp_only_metal_mats`
the (rp, rp) matrix along the line of sight (D @ xi.reshape(rp, rt)),
a configuration the stacking plan refuses, as vega_tpu's does.

With save-components (the fiducial's 'save-components') the plan refuses
every configuration, as vega_tpu's does (vega_tpu/metals.py:165): the
pairs run unrolled in every evaluation, fit included, and an evaluation
asked to save (a `component` name) keeps each pair's P(k, mu_k), xi and
distorted xi in `pk`, `xi` and `xi_distorted` under that component
(vega_tpu/metals.py:505-516). fast_metals and separate-metal-auto-biases
refuse save-components (ValueError), and so does, at a saved evaluation,
the bias product taken outside the pairs' spectra (fast_metal_bias,
on unless [model] sets it False: AssertionError), as in vega_tpu.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import correlation_func as corr_func
from . import pktoxi, power_spectrum, utils
from .coordinates import Coordinates
from .cosmo import ABSORBER_IGM
from .factored import (FactoredXi, RecordingParams, _broadcast_cat,
                       stack_coefficients)
from .io.fits import read_fits
from .native import pair_hist
from .ops.spline_combine import spline_legendre_combine
from .utils import col, host_row, to_tensor

# per-class constants `state` carries between the packages
PLAN_CONSTANTS = ('r', 'mu', 'growth', 'rel_z', 'moment_proj')


class Metals:
    """Metal correlations for one correlation component
    (reference: metals.py:13-142 for the configuration surface)."""

    def __init__(self, corr_item, fiducial, scale_params, data, *, device,
                 dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        self._corr_item = corr_item
        self._data = data
        self._scale_params = scale_params
        self.size = corr_item.model_coordinates.rp_grid.size
        self._coordinates = corr_item.model_coordinates
        self.cosmo = corr_item.cosmo
        config = corr_item.config
        self.rp_only_metal_mats = config['model'].getboolean(
            'rp_only_metal_mats', False)
        self.zmin = config['data'].getfloat('zmin', 0.0)
        self.zmax = config['data'].getfloat('zmax', 10.0)

        self.separate_metal_auto_biases = config['model'].getboolean(
            'separate-metal-auto-biases', False)
        self.single_metal_beta = config['model'].getboolean(
            'single-metal-beta', False)
        self.fast_metals = config['model'].getboolean('fast_metals', False)
        self.fast_metal_bias = config['model'].getboolean(
            'fast_metal_bias', True)
        if self.fast_metals or self.separate_metal_auto_biases:
            self.fast_metal_bias = True
        self.growth_rate = fiducial.get('growth_rate', None)

        self.save_components = fiducial.get('save-components', False)
        if self.save_components and (self.fast_metals
                                     or self.separate_metal_auto_biases):
            raise ValueError('Cannot save pk/cf components in fast_metals '
                             'mode. Either turn fast_metals off, or turn off '
                             'write_pk/write_cf.')
        self.pk = {'peak': {}, 'smooth': {}, 'full': {}}
        self.xi = {'peak': {}, 'smooth': {}, 'full': {}}
        self.xi_distorted = {'peak': {}, 'smooth': {}, 'full': {}}

        self.main_tracers = [corr_item.tracer1['name'],
                             corr_item.tracer2['name']]
        self.is_auto_correlation = (self.main_tracers[0]
                                    == self.main_tracers[1])
        self.main_tracer_types = [corr_item.tracer1['type'],
                                  corr_item.tracer2['type']]
        self.new_metals = corr_item.new_metals
        if self.new_metals:
            if 'metal-matrix' not in config:
                raise ValueError(f'{corr_item.name}: new_metals needs a '
                                 '[metal-matrix] section')
            if self.cosmo is None:
                raise ValueError(
                    f'{corr_item.name}: the new-metals matrices need the '
                    "cosmology of the data file's header (OMEGAM)")
            self.metal_matrix_config = config['metal-matrix']
            self.rp_nbins = self._coordinates.rp_nbins
            self.rt_nbins = self._coordinates.rt_nbins

        config['metals']['bin_size_rp'] = \
            str(corr_item.data_coordinates.rp_binsize)
        config['metals']['bin_size_rt'] = \
            str(corr_item.data_coordinates.rt_binsize)
        self.Pk_metal = {}
        self.PktoXi = {}
        self.Xi_metal = {}
        self._metal_mats = {}
        # host seconds of the new-metals matrices (pair histograms and
        # assembly, every pair)
        self.matrix_build_s = 0.
        shared_pktoxi = None
        for corr_hash in corr_item.metal_correlations:
            tracer1 = corr_item.tracer_catalog[corr_hash[0]]
            tracer2 = corr_item.tracer_catalog[corr_hash[1]]
            if self.new_metals:
                # the pair's matrix and its effective coordinates
                # (vega_tpu/metals.py:90-103)
                t0 = time.perf_counter()
                build = (self.compute_metal_rp_dmat if self.rp_only_metal_mats
                         else self.compute_metal_dmat)
                dmat, rp, rt, z = build(*corr_hash)
                self.matrix_build_s += time.perf_counter() - t0
                self._metal_mats[corr_hash] = to_tensor(dmat, self.device,
                                                        dtype)
                metal_coordinates = Coordinates.init_from_grids(
                    self._coordinates, rp, rt, z)
            elif corr_hash in data.metal_coordinates:
                metal_coordinates = data.metal_coordinates[corr_hash]
            else:
                metal_coordinates = data.metal_coordinates[corr_hash[::-1]]
            self.Pk_metal[corr_hash] = power_spectrum.PowerSpectrum(
                config['metals'], fiducial, tracer1, tracer2, corr_item.name,
                device=self.device, dtype=dtype)
            # every pair has the same (k, mu_k) grids and [model] options:
            # one transform plan serves them all
            if shared_pktoxi is None:
                shared_pktoxi = pktoxi.PktoXi.init_from_Pk(
                    self.Pk_metal[corr_hash], config['model'])
            self.PktoXi[corr_hash] = shared_pktoxi
            self.Xi_metal[corr_hash] = corr_func.CorrelationFunction(
                config['metals'], fiducial, metal_coordinates, scale_params,
                tracer1, tracer2, metal_corr=True, device=self.device,
                dtype=dtype, cosmo=self.cosmo)

        if self.new_metals:
            print(f'INFO: {corr_item.name}: {len(self._metal_mats)} '
                  f'new-metals matrices of {self.size} x {self.size} bins'
                  f'{" (rp only)" if self.rp_only_metal_mats else ""} built '
                  f'on the host in {self.matrix_build_s:.3f} s')

        # None: the unrolled per-pair loop (configs the plan refuses)
        self._stacked_plans = self._plan_stacking(corr_item)

    # ------------------------------------------------------------------
    # Stacked (batched) metal pipeline
    # ------------------------------------------------------------------
    def _plan_stacking(self, corr_item):
        """Group metal pairs into classes whose whole Pk -> xi pipelines
        are identical tensor programs differing only in scalars
        (vega_tpu/metals.py:143-237). Returns None (the unrolled loop)
        when per-pair structure differs in ways the stacked path does not
        express."""
        metals_config = corr_item.config['metals']
        unsupported = ['model-hcd', 'UVB-fluctuations', 'HeII-reionization',
                       'radiation effects', 'relativistic correction',
                       'standard asymmetry', 'UVB-shotnoise',
                       'single_multipole', 'new-bias-evolution',
                       'rescale-coords-systematics', 'pk-damping-scale']
        if any(key in metals_config for key in unsupported):
            return None
        # the extrapolated transform is not linear in P, which the
        # moment factorization cannot express (vega_tpu/metals.py:160-164;
        # the [model] section builds the metals' transform)
        if corr_item.config['model'].getboolean('fht_extrap', False):
            return None
        # saved components are per pair (vega_tpu/metals.py:165); rp-only
        # matrices act on the (rp, rt) grid, not on a pair's rows
        # (:164-165); metal-scaling rescales each pair's coordinates
        # (:167-168,239-242 read it off the pairs' shared scale
        # parameters)
        if (self.save_components or self._scale_params.metal_scaling
                or self.rp_only_metal_mats):
            return None
        # Croom's evolution is a per-tracer branch (:170-172)
        if any(key.startswith('z evol') and 'croom' in metals_config[key]
               for key in metals_config):
            return None

        has_arinyo = ('small scale nl' in metals_config
                      and 'arinyo' in metals_config['small scale nl'])

        classes = {}
        for corr_hash in corr_item.metal_correlations:
            name1, name2 = corr_hash
            t1 = corr_item.tracer_catalog[name1]
            t2 = corr_item.tracer_catalog[name2]
            drp_name = None
            if t1['type'] == 'discrete' and t2['type'] != 'discrete':
                drp_name = 'drp_' + name1
            elif t2['type'] == 'discrete' and t1['type'] != 'discrete':
                drp_name = 'drp_' + name2
            # Arinyo exponent per pair (reference: power_spectrum.py:448-477)
            if has_arinyo:
                two_lya = 'LY' in name1 and 'LY' in name2
                one_lya = 'LY' in name1 or 'LY' in name2
                exp = 1.0 if two_lya else (0.5 if one_lya else 0.0)
            else:
                exp = 0.0
            key = (t1['type'], t2['type'], drp_name, exp)
            classes.setdefault(key, []).append(corr_hash)

        plans = []
        for (_, _, drp_name, arinyo_exp), hashes in classes.items():
            xi_objs = [self.Xi_metal[h] for h in hashes]
            # Symmetry factor (reference: metals.py:237-239)
            sym = [2.0 if (self.is_auto_correlation and h[0] != h[1])
                   else 1.0 for h in hashes]
            # Kaiser moment tables: three mu-moment Legendre projections
            # of the shared grid per class, whatever the number of pairs
            pktoxi_rep = self.PktoXi[hashes[0]]
            pk_rep = self.Pk_metal[hashes[0]]
            muk = to_tensor(pk_rep.muk_grid.ravel(), self.device, self.dtype)
            plan = {
                'hashes': hashes, 'drp_name': drp_name,
                'arinyo_exp': arinyo_exp, 'sym': sym,
                'pk_rep': pk_rep, 'pktoxi_rep': pktoxi_rep,
                'r': torch.stack([x._r for x in xi_objs]),
                'mu': torch.stack([x._mu for x in xi_objs]),
                'growth': torch.stack([x.xi_growth * torch.ones_like(x._r)
                                       for x in xi_objs]),
                'rel_z': torch.stack([x._rel_z_evol * torch.ones_like(x._r)
                                      for x in xi_objs]),
                'moment_proj': torch.stack([
                    pktoxi_rep.legendre_proj * muk ** m for m in (0, 2, 4)]),
            }
            plans.append(plan)
        return plans

    def plan_constants(self):
        """[{name: numpy array}] of each class's PLAN_CONSTANTS (empty
        without a stacking plan)."""
        return [{name: plan[name].cpu().numpy() for name in PLAN_CONSTANTS}
                for plan in self._stacked_plans or []]

    def set_plan_constants(self, constants):
        """Install each class's PLAN_CONSTANTS from host arrays."""
        if len(constants) != len(self._stacked_plans or []):
            raise ValueError(f'{len(constants)} sets of constants for '
                             f'{len(self._stacked_plans or [])} classes')
        for plan, arrays in zip(self._stacked_plans or [], constants):
            for name in PLAN_CONSTANTS:
                if arrays[name].shape != tuple(plan[name].shape):
                    raise ValueError(f'{name} has shape {arrays[name].shape}, '
                                     f'the plan {tuple(plan[name].shape)}')
                plan[name] = to_tensor(arrays[name], self.device, self.dtype)

    def _local_pars(self, pars):
        """The parameters the pairs read: with fast_metals the growth
        rate stays at the fiducial one (vega_tpu/metals.py:277-280)."""
        local_pars = dict(pars)
        if (self.fast_metals and 'growth_rate' in local_pars
                and self.growth_rate is not None):
            local_pars['growth_rate'] = self.growth_rate
        return local_pars

    def _pair_weights_and_betas(self, local_pars):
        """Per-pair (weight, beta1, beta2, alpha1, alpha2) scalars
        (vega_tpu/metals.py:244-272), with the names of the two alphas."""
        out = {}
        for corr_hash in self._corr_item.metal_correlations:
            name1, name2 = corr_hash
            pars = dict(local_pars)
            if self.single_metal_beta:
                if name1 not in self.main_tracers:
                    pars[f'beta_{name1}'] = pars['beta_metals']
                if name2 not in self.main_tracers:
                    pars[f'beta_{name2}'] = pars['beta_metals']
            bias1, beta1, bias2, beta2 = utils.bias_beta(pars, name1, name2)
            is_cross_main = (name1 in self.main_tracers
                             or name2 in self.main_tracers)
            weight = bias1 * bias2
            if (self.separate_metal_auto_biases and not is_cross_main
                    and name1 != name2):
                if f'bias_{name1}_{name2}' in pars:
                    weight = weight * pars[f'bias_{name1}_{name2}']
                elif f'bias_{name2}_{name1}' in pars:
                    weight = weight * pars[f'bias_{name2}_{name1}']
                else:
                    raise ValueError(
                        f'No separate auto bias for {corr_hash}.')
            out[corr_hash] = (weight, beta1, beta2, pars[f'alpha_{name1}'],
                              pars[f'alpha_{name2}'])
        return out

    def coefficients(self, pars):
        """The coefficient part of the factored metal stack: per class,
        per pair, weight x (1, b1 + b2, b1 b2), floats or (B,) tensors in
        the order `compute_stacked` emits its basis rows."""
        pair_scalars = self._pair_weights_and_betas(self._local_pars(pars))
        coeffs = []
        for plan in self._stacked_plans:
            for i, h in enumerate(plan['hashes']):
                weight, beta1, beta2 = pair_scalars[h][:3]
                coeffs += self._moment_coefficients(
                    weight * plan['sym'][i], beta1, beta2)
        return coeffs

    @staticmethod
    def _moment_coefficients(weight, beta1, beta2):
        """A pair's coefficients of its three mu^(0,2,4) moment rows."""
        return [weight * 1.0, weight * (beta1 + beta2),
                weight * (beta1 * beta2)]

    def _class_coordinates(self, plan, local_pars):
        """(log r, mu, mask, out-of-range flag) of a class's pairs at
        ap = at = 1, shifted along the line of sight by the class's drp:
        (p, n), or (B, p, n) for a batched drp
        (vega_tpu/metals.py:346-361)."""
        r_grid, mu_grid = plan['r'], plan['mu']
        drp = 0.
        if plan['drp_name'] is not None:
            drp = col(local_pars.get(plan['drp_name'], 0.), 2)
        mask = r_grid != 0
        rp = r_grid * mu_grid + drp * mask.to(r_grid.dtype)
        rt = r_grid * torch.sqrt(1 - mu_grid ** 2)
        # the sqrt's argument guarded at r = 0 bins (sqrt'(0) = inf makes
        # the backward pass NaN even under an output where-mask)
        sq = rp ** 2 + rt ** 2
        pos = mask & (sq > 0)
        resc_r = torch.sqrt(torch.where(pos, sq, 1.0))
        resc_mu = torch.where(pos, rp, 0.) / torch.where(pos, resc_r, 1.0)
        log_r = torch.log(torch.where(pos, resc_r, 1.0))
        n_c = log_r.shape[0] if log_r.dim() == 3 else 1
        oob = plan['pktoxi_rep']._oob(log_r.reshape(n_c, -1),
                                      mask.expand(log_r.shape).reshape(n_c,
                                                                       -1))
        return log_r, resc_mu, mask, oob

    def compute_stacked(self, pars, pk_lin, use_kernel=True, sampling=None):
        """Batched metal computation: one tensor program per class
        (vega_tpu/metals.py:274-444). Returns (xi (B', n) or a
        FactoredXi, bad (B',))."""
        local_pars = self._local_pars(pars)
        pair_scalars = self._pair_weights_and_betas(local_pars)
        xi_metals = torch.zeros((1, self.size), dtype=self.dtype,
                                device=self.device)
        bad = torch.zeros(1, dtype=torch.bool, device=self.device)
        # Factored accumulation (factored.py): with a sampled set only
        factored = None
        if sampling is not None and sampling.sampled:
            factored = {'coeffs': [], 'rows': None}

        for plan in self._stacked_plans:
            hashes = plan['hashes']
            n_p = len(hashes)
            weights = [pair_scalars[h][0] * plan['sym'][i]
                       for i, h in enumerate(hashes)]
            beta1 = [pair_scalars[h][1] for h in hashes]
            beta2 = [pair_scalars[h][2] for h in hashes]
            alphas = [pair_scalars[h][3] for h in hashes] \
                + [pair_scalars[h][4] for h in hashes]
            alpha_names = [f'alpha_{h[0]}' for h in hashes] \
                + [f'alpha_{h[1]}' for h in hashes]

            # Shared (mu_k, k) grid: pk_lin times every factor that is
            # identical across the class (Arinyo via the class exponent)
            rec_shared = RecordingParams(local_pars, sampling)
            pk_obj, pktoxi_obj = plan['pk_rep'], plan['pktoxi_rep']
            grid = pk_lin.expand(pk_obj.k_par_grid.shape)
            shared = self._class_shared_factors(pk_obj, rec_shared)
            if shared is not None:
                grid = grid * shared
            if (pk_obj.small_scale_nl is not None
                    and 'arinyo' in pk_obj.small_scale_nl
                    and plan['arinyo_exp'] != 0.0):
                # as vega_tpu/metals.py:321-329: the representative
                # pair's own Arinyo term, its root for a class exponent
                # of 1/2
                dnl, dnl_bad = pk_obj.compute_dnl_arinyo(rec_shared)
                bad = bad | dnl_bad
                grid = grid * (dnl if plan['arinyo_exp'] == 1.0
                               else torch.sqrt(dnl))

            # Kaiser moment factorization: (3, L, N) knot tables of the
            # shared grid, (B, 3, L, N) when a batched parameter shaped it
            proj_m = torch.matmul(plan['moment_proj'], grid[..., None, :, :])
            t_m = torch.einsum('lij,...mlj->...mli', pktoxi_obj.fft_ops,
                               proj_m)
            d_m = torch.einsum('lij,...mlj->...mli', pktoxi_obj.fft_sd_ops,
                               proj_m)
            n_ell, n_knots = t_m.shape[-2:]

            log_r, resc_mu, mask, oob = self._class_coordinates(plan,
                                                                local_pars)
            bad = bad | oob
            leg = torch.stack([pktoxi.legendre(ell, resc_mu)
                               for ell in pktoxi_obj.ell_vals], dim=-2)
            n_q = log_r.shape[-1]

            drp_name = plan['drp_name']
            factorable = (
                factored is not None and not rec_shared.traced()
                and not (drp_name is not None and drp_name in local_pars
                         and sampling.traced(drp_name))
                and not any(name in sampling.sampled
                            for name in alpha_names))

            if factorable:
                # rows = (nodes) x pairs x 3 moments, each group of 3
                # reading its pair's coordinate row
                n_c = max(log_r.shape[0] if log_r.dim() == 3 else 1,
                          t_m.shape[0] if t_m.dim() == 4 else 1)

                def pair_rows(tables):  # ([n_c,] 3, L, N) -> (n_c p 3, L, N)
                    tables = tables.reshape((-1, 1, 3, n_ell, n_knots))
                    return tables.expand(n_c, n_p, 3, n_ell, n_knots).reshape(
                        n_c * n_p * 3, n_ell, n_knots)

                rows = spline_legendre_combine(
                    pktoxi_obj.knot_grid, pair_rows(t_m), pair_rows(d_m),
                    log_r.expand(n_c, n_p, n_q).reshape(n_c * n_p, n_q),
                    leg.expand(n_c, n_p, n_ell, n_q).reshape(
                        n_c * n_p, n_ell, n_q),
                    group=3, use_kernel=use_kernel)
                rows = rows.reshape(n_c, n_p, 3, n_q)
                rows = torch.where(mask[..., None, :], rows, 0.0)
                evol = (plan['rel_z'] ** stack_coefficients(
                            alphas[:n_p], log_r)[:, None]
                        * plan['rel_z'] ** stack_coefficients(
                            alphas[n_p:], log_r)[:, None])
                rows = rows * (evol * plan['growth'])[:, None, :]
                if n_c == 1 and log_r.dim() == 2 and t_m.dim() == 3:
                    rows = rows[0]
                for i, h in enumerate(hashes):
                    pair = self.apply_metal_matrix(rows[..., i, :, :], h)
                    factored['coeffs'] += self._moment_coefficients(
                        weights[i], beta1[i], beta2[i])
                    factored['rows'] = (
                        pair if factored['rows'] is None
                        else _broadcast_cat(factored['rows'], pair))
                continue

            # This plan cannot factor: fold any factored contributions
            # back into the dense accumulator and stay dense
            if factored is not None and factored['rows'] is not None:
                xi_metals = xi_metals + FactoredXi(
                    factored['coeffs'], factored['rows']).dense()
            factored = None

            # knot tables of every pair, pair-major: (p, B', L N)
            coeffs = torch.stack(torch.broadcast_tensors(*[
                stack_coefficients(column, log_r).reshape(-1, n_p)
                for column in (
                    [1.0] * n_p,
                    [b1 + b2 for b1, b2 in zip(beta1, beta2)],
                    [b1 * b2 for b1, b2 in zip(beta1, beta2)])]),
                dim=-1)                                      # (B', p, 3)
            n_b = max(coeffs.shape[0], t_m.shape[0] if t_m.dim() == 4 else 1,
                      log_r.shape[0] if log_r.dim() == 3 else 1)

            def pair_knots(tables):
                tables = tables.reshape(-1, 3, n_ell * n_knots)
                n_t = max(coeffs.shape[0], tables.shape[0])
                knots = torch.einsum(
                    'bpm,bmk->pbk', coeffs.expand(n_t, n_p, 3),
                    tables.expand(n_t, 3, n_ell * n_knots))
                return knots.expand(n_p, n_b, n_ell * n_knots)

            xi_knots, m_knots = pair_knots(t_m), pair_knots(d_m)
            if log_r.dim() == 3:
                # a batched drp moves every row's coordinates: a
                # coordinate row per (batch, pair)
                def batch_major(knots):
                    return knots.transpose(0, 1).reshape(
                        n_b * n_p, n_ell, n_knots).contiguous()

                xi_stack = spline_legendre_combine(
                    pktoxi_obj.knot_grid, batch_major(xi_knots),
                    batch_major(m_knots), log_r.reshape(n_b * n_p, n_q),
                    leg.reshape(n_b * n_p, n_ell, n_q),
                    use_kernel=use_kernel)
                xi_stack = xi_stack.reshape(n_b, n_p, n_q).transpose(0, 1)
            else:
                # pair-major rows: each pair's batch shares its coordinate
                # row (row groups of the batch size)
                xi_stack = spline_legendre_combine(
                    pktoxi_obj.knot_grid,
                    xi_knots.reshape(n_p * n_b, n_ell, n_knots).contiguous(),
                    m_knots.reshape(n_p * n_b, n_ell, n_knots).contiguous(),
                    log_r, leg, group=n_b, use_kernel=use_kernel)
                xi_stack = xi_stack.reshape(n_p, n_b, n_q)
            # (p, B', n)
            xi_stack = torch.where(mask[:, None, :], xi_stack, 0.0)

            # Bias z-evolution and growth (std model; reference:
            # correlation_func.py:332-349)
            rel_z = plan['rel_z'][:, None, :]
            xi_stack = xi_stack * rel_z ** self._pair_column(
                alphas[:n_p], log_r) * rel_z ** self._pair_column(
                alphas[n_p:], log_r)
            xi_stack = xi_stack * plan['growth'][:, None, :]

            # Metal matrices + weighted accumulation
            total = None
            for i, h in enumerate(hashes):
                xi_i = col(weights[i], 1) * self.apply_metal_matrix(
                    xi_stack[i], h)
                total = xi_i if total is None else total + xi_i
            xi_metals = xi_metals + total

        if factored is not None and factored['rows'] is not None:
            return FactoredXi(factored['coeffs'], factored['rows']), bad
        return xi_metals, bad

    @staticmethod
    def _pair_column(scalars, like):
        """Per-pair scalars (floats or (B,) tensors) as (p, B', 1)."""
        stacked = stack_coefficients(scalars, like)         # (p,) or (B, p)
        return stacked.reshape(-1, len(scalars)).transpose(0, 1)[..., None]

    @staticmethod
    def _class_shared_factors(pk_obj, local_pars):
        """Multiplicative (mu_k, k) factors shared by every pair of a
        class, in vega_tpu's order (vega_tpu/metals.py:446-488): the
        binning window (the static one: vega_tpu's stacked path reads no
        `par / per binsize` parameter), the mock binning window, the
        full-shape smoothing, the velocity dispersion and the McDonald
        term. The smoothing is the representative pair's, as vega_tpu
        takes it."""
        factors = []
        if pk_obj.use_Gk:
            factors.append(pk_obj.pk_Gk)
        if pk_obj.mock_bin_size is not None:
            factors.append(pk_obj._compute_mock_binsize_gk(local_pars))
        smoothing = pk_obj._fullshape_smoothing(local_pars)
        if smoothing is not None:
            factors.append(smoothing)
        factors += pk_obj._velocity_dispersion_factors(local_pars)
        if (pk_obj.small_scale_nl is not None
                and 'mcdonald' in pk_obj.small_scale_nl):
            factors.append(pk_obj.compute_dnl_mcdonald())
        factor = None
        for f in factors:
            factor = f if factor is None else factor * f
        return factor

    # ------------------------------------------------------------------
    # Unrolled per-pair loop
    # ------------------------------------------------------------------
    def compute_metal_corr(self, pars, pk_lin, corr_hash, fast_metals,
                           use_kernel=True, component=None, *,
                           add_metal_dmat=True):
        """One metal sub-correlation with its metal matrix applied, unless
        add_metal_dmat is False (vega_tpu/metals.py:491-517). Returns (xi
        (B', n), bad). With save-components and a `component`, the pair's
        spectrum, xi and distorted xi are saved under it."""
        pk, bad_pk = self.Pk_metal[corr_hash].compute(
            pk_lin, pars, fast_metals=fast_metals)
        xi, bad_xi = self.Xi_metal[corr_hash].compute(
            pk, self.PktoXi[corr_hash], pars, use_kernel, pk_lin=pk_lin)
        # Cross-metal symmetry in autos (reference: metals.py:237-239)
        if self.is_auto_correlation and corr_hash[0] != corr_hash[1]:
            xi = xi * 2
        save = self.save_components and component is not None
        if save:
            if fast_metals:
                raise AssertionError('You need to set fast_metal_bias=False.')
            self.pk[component][corr_hash] = host_row(pk, 2)
            self.xi[component][corr_hash] = host_row(xi, 1)
        if not add_metal_dmat:
            return xi, bad_pk | bad_xi
        xi = self.apply_metal_matrix(xi, corr_hash)
        if save:
            self.xi_distorted[component][corr_hash] = host_row(xi, 1)
        return xi, bad_pk | bad_xi

    # vega_tpu's reference-named views of the per-pair computation
    # (vega_tpu/metals.py:519-540): compute_metal_corr without its flag
    def compute_metal_corr_slow(self, pars, pk_lin, corr_hash, fast_metals,
                                add_metal_dmat=True, component=None):
        return self.compute_metal_corr(pars, pk_lin, corr_hash, fast_metals,
                                       component=component,
                                       add_metal_dmat=add_metal_dmat)[0]

    def compute_xi_metal_metal(self, pk_lin, pars, corr_hash):
        return self.compute_metal_corr_slow(pars, pk_lin, corr_hash,
                                            fast_metals=True)

    def compute_xi_metal_cross_main(self, pk_lin, pars, corr_hash,
                                    beta1, beta2):
        del beta1, beta2    # the reference's cache keys; no cache here
        xi, _ = self.compute_metal_corr(pars, pk_lin, corr_hash, True,
                                        add_metal_dmat=False)
        return self.apply_metal_matrix(xi, corr_hash)

    def compute(self, pars, pk_lin, use_kernel=True, sampling=None,
                component=None):
        """Sum of all metal correlations (vega_tpu/metals.py:542-603).
        Returns (xi_metals (B', n) or a FactoredXi, bad). `component`
        names the component an evaluation saves (save-components)."""
        if self._stacked_plans is not None:
            return self.compute_stacked(pars, pk_lin, use_kernel, sampling)
        return self.compute_unrolled(pars, pk_lin, use_kernel, component)

    def compute_unrolled(self, pars, pk_lin, use_kernel=True,
                         component=None):
        """The per-pair loop (vega_tpu/metals.py:553-603): the path of
        configurations the stacking plan refuses."""
        local_pars = self._local_pars(pars)
        xi_metals = torch.zeros((1, self.size), dtype=self.dtype,
                                device=self.device)
        bad = torch.zeros(1, dtype=torch.bool, device=self.device)
        use_fast_bias = self.fast_metals or self.fast_metal_bias
        for corr_hash in self._corr_item.metal_correlations:
            name1, name2 = corr_hash
            if self.single_metal_beta:
                if name1 not in self.main_tracers:
                    local_pars[f'beta_{name1}'] = local_pars['beta_metals']
                if name2 not in self.main_tracers:
                    local_pars[f'beta_{name2}'] = local_pars['beta_metals']
            bias1, _, bias2, _ = utils.bias_beta(local_pars, name1, name2)
            bias_product = bias1 * bias2
            is_cross_with_main = (name1 in self.main_tracers
                                  or name2 in self.main_tracers)
            if (not is_cross_with_main and self.separate_metal_auto_biases
                    and name1 != name2):
                if f'bias_{name1}_{name2}' in local_pars:
                    factor = local_pars[f'bias_{name1}_{name2}']
                elif f'bias_{name2}_{name1}' in local_pars:
                    factor = local_pars[f'bias_{name2}_{name1}']
                else:
                    raise ValueError(
                        'Separate metal auto biases is on, but no '
                        f'bias_{name1}_{name2} or bias_{name2}_{name1} '
                        f'parameter found for {corr_hash}.')
                bias_product = bias_product * factor
            xi, xi_bad = self.compute_metal_corr(
                local_pars, pk_lin, corr_hash, use_fast_bias, use_kernel,
                component)
            bad = bad | xi_bad
            if use_fast_bias:
                xi = col(bias_product, 1) * xi
            xi_metals = xi_metals + xi
        return xi_metals, bad

    def apply_metal_matrix(self, xi, corr_hash):
        """xi (..., n) -> (..., n) through the pair's metal distortion
        matrix (vega_tpu/metals.py:605-629): the new-metals matrix, full
        (xi @ D^T) or rp-only (D along the rp axis of the (rp, rt) grid),
        else the legacy file's, where identity matrices (test mode, or a
        file that holds the identity) are skipped."""
        if self.new_metals:
            dmat = self._metal_mats[corr_hash]
            if self.rp_only_metal_mats:
                grid = xi.reshape(xi.shape[:-1] + (self.rp_nbins,
                                                   self.rt_nbins))
                return torch.matmul(dmat, grid).reshape(xi.shape)
            return xi @ dmat.T
        if corr_hash not in self._metal_mats:
            mats = self._data.metal_mats
            dmat = mats[corr_hash if corr_hash in mats else corr_hash[::-1]]
            if dmat is not None:
                dmat = np.asarray(dmat, dtype=np.float64)
                dmat = (None if np.array_equal(dmat, np.eye(*dmat.shape))
                        else to_tensor(dmat, self.device, self.dtype))
            self._metal_mats[corr_hash] = dmat
        dmat = self._metal_mats[corr_hash]
        return xi if dmat is None else xi @ dmat.T

    # ------------------------------------------------------------------
    # New-metals distortion matrices: host work at construction
    # (vega_tpu/metals.py:636-914). `route` 'native' takes the C++ pair
    # histograms (native/pair_hist.cpp), 'numpy' materializes every pair
    # as vega_tpu's numpy route does.
    # ------------------------------------------------------------------
    @staticmethod
    def rebin(vector, rebin_factor):
        size = vector.size
        return vector[:(size // rebin_factor) * rebin_factor].reshape(
            (size // rebin_factor), rebin_factor).mean(-1)

    def get_forest_weights(self, main_tracer):
        """(vega_tpu/metals.py:641-652)"""
        assert main_tracer['type'] == 'continuous'
        hdul = read_fits(utils.find_file(main_tracer['weights-path']))
        wave = 10 ** hdul[1]['LOGLAM']
        weights = hdul[1]['WEIGHT']
        rebin_factor = self.metal_matrix_config.getint('rebin_factor', None)
        if rebin_factor is not None:
            wave = self.rebin(wave, rebin_factor)
            weights = self.rebin(weights, rebin_factor)
        return wave, weights

    def get_qso_weights(self, tracer):
        """(vega_tpu/metals.py:654-671)"""
        assert tracer['type'] == 'discrete'
        hdul = read_fits(utils.find_file(tracer['weights-path']))
        z_qso_cat = hdul[1]['Z']
        z_ref = self.metal_matrix_config.getfloat('z_ref_objects', 2.25)
        z_evol = self.metal_matrix_config.getfloat('z_evol_objects', 1.44)
        qso_z_bins = self.metal_matrix_config.getint('z_bins_objects', 1000)
        weights_cat = ((1. + z_qso_cat) / (1. + z_ref)) ** (z_evol - 1.)

        histo_w, zbins = np.histogram(z_qso_cat, bins=qso_z_bins,
                                      weights=weights_cat)
        histo_wz, _ = np.histogram(z_qso_cat, bins=zbins,
                                   weights=weights_cat * z_qso_cat)
        selection = histo_w > 0
        z_qso = histo_wz[selection] / histo_w[selection]
        return z_qso, histo_w[selection]

    def get_rp_pairs(self, z1, z2):
        """(vega_tpu/metals.py:673-684)"""
        if np.any(z1 < 0) or np.any(z2 < 0):
            raise ValueError(
                'Attempting to compute distance to a negative redshift')
        r1 = self.cosmo.get_r_comov(z1)
        r2 = self.cosmo.get_r_comov(z2)
        rp_pairs = (r1[:, None] - r2[None, :]).ravel()
        if 'discrete' not in self.main_tracer_types:
            rp_pairs = np.abs(rp_pairs)
        mean_distance = ((r1[:, None] + r2[None, :]) / 2).ravel()
        return rp_pairs, mean_distance

    def get_forest_weight_scaling(self, z, true_abs, assumed_abs):
        """(vega_tpu/metals.py:686-691)"""
        true_alpha = self.metal_matrix_config.getfloat(f'alpha_{true_abs}')
        assumed_alpha = self.metal_matrix_config.getfloat(
            f'alpha_{assumed_abs}', 2.9)
        return (1 + z) ** (true_alpha + assumed_alpha - 2)

    def _tracer_weights(self, tracer, main_idx, true_abs):
        """(vega_tpu/metals.py:693-703)"""
        if self.main_tracer_types[main_idx] == 'continuous':
            wave, weights = self.get_forest_weights(tracer)
            true_z = wave / ABSORBER_IGM[true_abs] - 1.
            assumed_z = wave / ABSORBER_IGM[self.main_tracers[main_idx]] - 1.
            scaling = self.get_forest_weight_scaling(
                true_z, true_abs, self.main_tracers[main_idx])
        else:
            true_z, weights = self.get_qso_weights(tracer)
            assumed_z = true_z
            scaling = 1.
        return true_z, assumed_z, weights, scaling

    def _pair_histogram_native(self, true_abs_1, true_abs_2, rp_edges,
                               n_ratio_bins):
        """Streamed O(n1 n2) pair histograms through the C++ kernel
        (vega_tpu/metals.py:705-752); a failed build raises."""
        true_z1, assumed_z1, weights1, scaling_1 = self._tracer_weights(
            self._corr_item.tracer1, 0, true_abs_1)
        true_z2, assumed_z2, weights2, scaling_2 = self._tracer_weights(
            self._corr_item.tracer2, 1, true_abs_2)
        if np.any(true_z1 < 0) or np.any(true_z2 < 0):
            raise ValueError(
                'Attempting to compute distance to a negative redshift')

        true_r1 = self.cosmo.get_r_comov(true_z1)
        true_r2 = self.cosmo.get_r_comov(true_z2)
        assumed_r1 = self.cosmo.get_r_comov(assumed_z1)
        assumed_r2 = self.cosmo.get_r_comov(assumed_z2)
        abs_rp = int('discrete' not in self.main_tracer_types)

        ratio_edges = None
        if n_ratio_bins:
            lo, hi = pair_hist.pair_ratio_range(true_r1, assumed_r1,
                                                true_r2, assumed_r2)
            if lo == hi:  # np.histogram degenerate-range convention
                lo, hi = lo - 0.5, hi + 0.5
            ratio_edges = np.linspace(lo, hi, n_ratio_bins + 1)

        out = pair_hist.pair_histograms(
            true_r1, assumed_r1, true_z1 * np.ones_like(true_r1),
            assumed_z1 * np.ones_like(assumed_r1),
            weights1 * scaling_1 * np.ones_like(true_r1),
            true_r2, assumed_r2, true_z2 * np.ones_like(true_r2),
            assumed_z2 * np.ones_like(assumed_r2),
            weights2 * scaling_2 * np.ones_like(true_r2),
            abs_rp, self.zmin, self.zmax, rp_edges, ratio_edges)
        h2, sum_true, sum_assumed, sum_assumed_rp, sum_z, ratio_hist = out
        ratios = ((ratio_edges[1:] + ratio_edges[:-1]) / 2
                  if ratio_edges is not None else None)
        return (h2, sum_true, sum_assumed, sum_assumed_rp, sum_z,
                ratio_hist, ratios)

    def _numpy_pairs(self, true_abs_1, true_abs_2):
        """Every pair materialized, as vega_tpu's numpy route:
        (true rp, true mean distance, assumed rp, assumed mean distance,
        weights, mean true z) per pair."""
        true_z1, assumed_z1, weights1, scaling_1 = self._tracer_weights(
            self._corr_item.tracer1, 0, true_abs_1)
        true_z2, assumed_z2, weights2, scaling_2 = self._tracer_weights(
            self._corr_item.tracer2, 1, true_abs_2)
        true_rp_pairs, true_mean_dist = self.get_rp_pairs(true_z1, true_z2)
        assumed_rp_pairs, assumed_mean_dist = self.get_rp_pairs(
            assumed_z1, assumed_z2)
        weights = ((weights1 * scaling_1)[:, None]
                   * (weights2 * scaling_2)[None, :]).ravel()
        zpair = (assumed_z1[:, None] + assumed_z2[None, :]) / 2.
        weights = weights * ((zpair >= self.zmin)
                             & (zpair <= self.zmax)).ravel()
        true_zpair = ((true_z1[:, None] + true_z2[None, :]) / 2.).ravel()
        return (true_rp_pairs, true_mean_dist, assumed_rp_pairs,
                assumed_mean_dist, weights, true_zpair)

    @staticmethod
    def _rp_sums(assumed_rp_pairs, weights, true_zpair, rp_edges):
        """Weight, weight x rp and weight x z per assumed-rp bin."""
        sum_w, _ = np.histogram(assumed_rp_pairs, bins=rp_edges,
                                weights=weights)
        sum_w_rp, _ = np.histogram(assumed_rp_pairs, bins=rp_edges,
                                   weights=weights * assumed_rp_pairs)
        sum_w_z, _ = np.histogram(assumed_rp_pairs, bins=rp_edges,
                                  weights=weights * true_zpair)
        return sum_w, sum_w_rp, sum_w_z

    def compute_metal_dmat(self, true_abs_1, true_abs_2, route='native'):
        """Full (rp x rt) metal distortion matrix and the pair's
        effective (rp, rt, z) coordinates from the stacked-delta weights
        (vega_tpu/metals.py:754-818)."""
        rp_edges = np.linspace(self._coordinates.rp_min,
                               self._coordinates.rp_max, self.rp_nbins + 1)
        rt_edges = np.linspace(0, self._coordinates.rt_max,
                               self.rt_nbins + 1)

        if route == 'native':
            (rp_1d_dmat, _, sum_w, sum_w_rp, sum_w_z, ratio_weights,
             ratios) = self._pair_histogram_native(
                true_abs_1, true_abs_2, rp_edges, 4 * rt_edges.size)
            col_sum = np.sum(rp_1d_dmat, axis=0)
            rp_1d_dmat = rp_1d_dmat / (col_sum + (col_sum == 0))
            return self._assemble_metal_dmat(
                rp_1d_dmat, sum_w, sum_w_rp, sum_w_z, ratio_weights,
                ratios, rt_edges)
        if route != 'numpy':
            raise ValueError(f"route is 'native' or 'numpy', not {route!r}")

        (true_rp_pairs, true_mean_dist, assumed_rp_pairs, assumed_mean_dist,
         weights, true_zpair) = self._numpy_pairs(true_abs_1, true_abs_2)
        rp_1d_dmat, _, _ = np.histogram2d(
            assumed_rp_pairs, true_rp_pairs, bins=(rp_edges, rp_edges),
            weights=weights)
        col_sum = np.sum(rp_1d_dmat, axis=0)
        rp_1d_dmat /= (col_sum + (col_sum == 0))

        # distance-ratio histogram with solid-angle weighting, restricted
        # to small true rp (vega_tpu/metals.py:800-806)
        ratio_weights, ratio_bins = np.histogram(
            assumed_mean_dist / true_mean_dist, bins=4 * rt_edges.size,
            weights=weights / true_mean_dist ** 2
            * (np.abs(true_rp_pairs) < 20.))
        ratios = (ratio_bins[1:] + ratio_bins[:-1]) / 2
        return self._assemble_metal_dmat(
            rp_1d_dmat,
            *self._rp_sums(assumed_rp_pairs, weights, true_zpair, rp_edges),
            ratio_weights, ratios, rt_edges)

    def _assemble_metal_dmat(self, rp_1d_dmat, sum_w, sum_w_rp, sum_w_z,
                             ratio_weights, ratios, rt_edges):
        """rt distortion from the ratio histogram, the (rp x rt) matrix
        and the effective coordinates (vega_tpu/metals.py:820-855)."""
        rt_centers = (rt_edges[:-1] + rt_edges[1:]) / 2
        rt_half = self._coordinates.rt_binsize / 2
        oversample = 7
        delta_rt = np.linspace(-rt_half, rt_half * (1 - 2 / oversample),
                               oversample)[None, :]
        rt_1d_dmat = np.zeros((self.rt_nbins, self.rt_nbins))
        for i, rt in enumerate(rt_centers):
            rt_1d_dmat[:, i], _ = np.histogram(
                (ratios[:, None] * (rt + delta_rt)[None, :]).ravel(),
                bins=rt_edges,
                weights=(ratio_weights[:, None]
                         * (rt + delta_rt)[None, :]).ravel())
        col_sum = np.sum(rt_1d_dmat, axis=0)
        rt_1d_dmat /= (col_sum + (col_sum == 0))

        n_total = self.rp_nbins * self.rt_nbins
        dmat = np.einsum('ij,kl->ikjl', rp_1d_dmat, rt_1d_dmat).reshape(
            n_total, n_total)

        rp_eff_1d = sum_w_rp / (sum_w + (sum_w == 0))
        z_eff_1d = sum_w_z / (sum_w + (sum_w == 0))

        rt_max = self._coordinates.rt_max
        r1 = np.arange(self.rt_nbins) * rt_max / self.rt_nbins
        r2 = (1 + np.arange(self.rt_nbins)) * rt_max / self.rt_nbins
        rt_eff_1d = (2 * (r2 ** 3 - r1 ** 3)) / (3 * (r2 ** 2 - r1 ** 2))

        full_index = np.arange(n_total)
        rt_index = full_index % self.rt_nbins
        rp_index = full_index // self.rt_nbins
        return (dmat, rp_eff_1d[rp_index], rt_eff_1d[rt_index],
                z_eff_1d[rp_index])

    def compute_metal_rp_dmat(self, true_abs_1, true_abs_2, route='native'):
        """rp-only metal distortion matrix (rp_nbins, rp_nbins) and the
        effective coordinates (vega_tpu/metals.py:857-893)."""
        rp_edges = np.linspace(self._coordinates.rp_min,
                               self._coordinates.rp_max, self.rp_nbins + 1)

        if route == 'native':
            dmat, sum_true, sum_w, sum_w_rp, sum_w_z, _, _ = \
                self._pair_histogram_native(true_abs_1, true_abs_2,
                                            rp_edges, 0)
            dmat = dmat * ((sum_true > 0)
                           / (sum_true + (sum_true == 0)))[None, :]
            return self._assemble_metal_rp_dmat(dmat, sum_w, sum_w_rp,
                                                sum_w_z)
        if route != 'numpy':
            raise ValueError(f"route is 'native' or 'numpy', not {route!r}")

        true_rp_pairs, _, assumed_rp_pairs, _, weights, true_zpair = \
            self._numpy_pairs(true_abs_1, true_abs_2)
        dmat, _, _ = np.histogram2d(
            assumed_rp_pairs, true_rp_pairs, bins=(rp_edges, rp_edges),
            weights=weights)
        sum_true, _ = np.histogram(true_rp_pairs, bins=rp_edges,
                                   weights=weights)
        dmat *= ((sum_true > 0) / (sum_true + (sum_true == 0)))[None, :]
        return self._assemble_metal_rp_dmat(
            dmat, *self._rp_sums(assumed_rp_pairs, weights, true_zpair,
                                 rp_edges))

    def _assemble_metal_rp_dmat(self, dmat, sum_w, sum_w_rp, sum_w_z):
        """Effective coordinates of the rp-only matrix
        (vega_tpu/metals.py:895-914)."""
        rp_eff = sum_w_rp / (sum_w + (sum_w == 0))
        z_eff = sum_w_z / (sum_w + (sum_w == 0))

        n_total = self.rp_nbins * self.rt_nbins
        full_rp_eff = np.zeros(n_total)
        full_rt_eff = np.zeros(n_total)
        full_z_eff = np.zeros(n_total)
        rp_indices = np.arange(self.rp_nbins)
        rt_bins = np.arange(self._coordinates.rt_binsize / 2,
                            self._coordinates.rt_max,
                            self._coordinates.rt_binsize)
        for j in range(self.rt_nbins):
            indices = j + self.rt_nbins * rp_indices
            full_rp_eff[indices] = rp_eff
            full_rt_eff[indices] = rt_bins[j]
            full_z_eff[indices] = z_eff
        return dmat, full_rp_eff, full_rt_eff, full_z_eff
