"""chi^2 minimizer.

Copy of vega_tpu/minimizer.py (numpy and scipy only, pinned to it by
tests/test_torch_minimizer.py). The reference wraps iminuit's MIGRAD
(C++ MINUIT2; reference: vega/minimizer.py). Here minimization is
gradient-based with exact derivatives, which the caller provides: the
port's VegaInterface gives torch autograd gradients (no finite-difference
chi^2 evaluations at all) and parameter errors come from the exact
Hessian at the minimum (covariance = 2 H^-1 for a chi^2 with errordef =
1).

The reference's two-stage strategy (bias-only pre-fit, then all
parameters; minimizer.py:67-98) and its results API (values/errors/
covariance/fmin) are preserved. Left out: vega_tpu's fused
value+gradient+Hessian path (`valgradhess_func`, VEGA_TPU_FUSED_FIT),
which is off by default there; with it off the two fit alike.
"""

from __future__ import annotations

import copy
import sys
import time
from types import SimpleNamespace

import numpy as np
from scipy.optimize import minimize as scipy_minimize


class CovarianceView:
    """Covariance access shim: indexable by (name1, name2), iterable via
    items(), and convertible with np.array()."""

    def __init__(self, matrix, names):
        self._matrix = np.asarray(matrix)
        self._names = list(names)
        self._index = {name: i for i, name in enumerate(self._names)}

    def __getitem__(self, key):
        if isinstance(key, tuple) and isinstance(key[0], str):
            return self._matrix[self._index[key[0]], self._index[key[1]]]
        return self._matrix[key]

    def items(self):
        for i, n1 in enumerate(self._names):
            for j, n2 in enumerate(self._names):
                yield (n1, n2), self._matrix[i, j]

    def __array__(self, dtype=None, copy=None):
        arr = self._matrix
        if dtype is not None:
            arr = arr.astype(dtype)
        return np.array(arr) if copy else arr

    def to_dict(self):
        return {key: val for key, val in self.items()}


class Minimizer:
    """Gradient-based minimizer with a Minuit-compatible results surface
    (reference: minimizer.py:8-188)."""

    def __init__(self, chi2_func, sample_params, grad_func=None,
                 hess_func=None, valgrad_func=None):
        self.chi2_func = chi2_func
        self.grad_func = grad_func
        self.hess_func = hess_func
        # fused value+gradient (one backward pass gives both)
        self.valgrad_func = valgrad_func
        self._names = list(sample_params['limits'].keys())
        self._sample_params = sample_params
        self.run_flag = False

        self._values = None
        self._errors = None
        self._covariance = None
        self._fmin = None

    # ------------------------------------------------------------------
    def chi2(self, *pars):
        """Positional wrapper (reference: minimizer.py:28-37)."""
        sample_params = {par: pars[i] for i, par in enumerate(self._names)}
        return self.chi2_func(sample_params)

    def _chi2_dict(self, params_dict):
        return float(self.chi2_func(params_dict))

    def _grad_dict(self, params_dict):
        if self.grad_func is None:
            return None
        return self.grad_func(params_dict)

    # ------------------------------------------------------------------
    def _grad_at(self, params_full, free_names):
        """Exact gradient vector at a point (None when no gradient
        provider is configured)."""
        grads = None
        if self.valgrad_func is not None:
            _, grads = self.valgrad_func(dict(params_full))
        elif self.grad_func is not None:
            grads = self.grad_func(dict(params_full))
        if grads is None:
            return None
        return np.array([grads[name] for name in free_names])

    @staticmethod
    def _use_minuit():
        """True when the optional iminuit (MIGRAD) backend is requested
        AND importable. The reference always fits with MIGRAD (reference:
        minimizer.py:39-103); this backend reproduces its exact fit
        trajectory for users who need it, fed by the chi^2 and exact
        gradients instead of finite differences."""
        import os
        if os.environ.get('VEGA_TPU_MINIMIZER', '').lower() != 'migrad':
            return False
        try:
            import iminuit  # noqa: F401
            return True
        except ImportError:
            print('WARNING: VEGA_TPU_MINIMIZER=migrad but iminuit is not '
                  'installed; falling back to the native minimizer')
            return False

    def _solve_migrad(self, free_names, params_init, errors, limits,
                      fixed_values):
        """One MIGRAD run over free_names via iminuit (reference:
        minimizer.py:67-98), with the exact gradient injected so
        MINUIT skips its finite-difference evaluations.

        Returns (minuit_object, bestfit_dict)."""
        import iminuit

        def fun(x):
            full = dict(fixed_values)
            full.update({n: float(v) for n, v in zip(free_names, x)})
            return self._chi2_dict(full)

        def jac(x):
            full = dict(fixed_values)
            full.update({n: float(v) for n, v in zip(free_names, x)})
            g = self._grad_at(full, free_names)
            return g if g is not None else np.zeros(len(free_names))

        has_grad = (self.valgrad_func is not None
                    or self.grad_func is not None)
        x0 = np.array([params_init[n] for n in free_names])
        minuit = iminuit.Minuit(fun, x0, grad=jac if has_grad else None,
                                name=list(free_names))
        minuit.errordef = 1
        for name in free_names:
            if name in errors:
                minuit.errors[name] = errors[name]
            if name in limits:
                minuit.limits[name] = limits[name]
        minuit.print_level = 1
        minuit.migrad(ncall=int(1e5))
        bestfit = dict(fixed_values)
        bestfit.update({n: float(minuit.values[n]) for n in free_names})
        return minuit, bestfit

    def _minimize_migrad(self, params_init, errors, limits, fixed_values,
                         free_names):
        """Two-stage MIGRAD fit mirroring the reference's strategy
        (bias-only pre-fit then full; reference: minimizer.py:66-98)."""
        bias_names = [n for n in free_names if 'bias' in n]
        if bias_names and len(bias_names) < len(free_names):
            _, stage1_fit = self._solve_migrad(
                bias_names, params_init, errors, limits, fixed_values)
            for name in bias_names:
                params_init[name] = stage1_fit[name]
                fixed_values[name] = stage1_fit[name]

        minuit, bestfit = self._solve_migrad(
            free_names, params_init, errors, limits, fixed_values)
        minuit.hesse()
        cov = np.full((len(free_names), len(free_names)), np.nan)
        hesse_failed = bool(minuit.fmin.hesse_failed)
        if not hesse_failed and minuit.covariance is not None:
            cov = np.array([[minuit.covariance[(n1, n2)]
                             for n2 in free_names] for n1 in free_names])
        err_vec = np.array([float(minuit.errors[n]) for n in free_names])
        return (bestfit, float(minuit.fmin.fval),
                bool(minuit.fmin.is_valid), float(minuit.fmin.edm),
                cov, err_vec, hesse_failed)

    # ------------------------------------------------------------------
    def _newton_polish(self, fun, result, free_names, bounds, unpack,
                       max_iter=8):
        """Projected active-set Newton polish at the L-BFGS-B solution.

        L-BFGS-B's curvature model goes flat near a tight minimum; with
        the exact Hessian available (the same one _compute_errors needs
        for the parameter covariance), a few damped Newton steps reach
        machine-precision stationarity in ~2-4 Hessian evaluations
        instead of the ~25-evaluation tight-ftol L-BFGS-B restart this
        replaces. Components pinned at a bound with the gradient pushing
        outward are frozen (the same projection the EDM uses); the step
        on the free block is Levenberg-damped until it actually lowers
        the chi^2."""
        x = np.array(result.x, dtype=float)
        fval = float(result.fun)
        n = len(free_names)
        lo = np.array([-np.inf if b[0] is None else b[0] for b in bounds])
        hi = np.array([np.inf if b[1] is None else b[1] for b in bounds])
        ftol = 1e-13 * max(1.0, abs(fval))
        for _ in range(max_iter):
            val, g = fun(x)
            hess_dict = self.hess_func(unpack(x), free_names)
            hess = np.array([[hess_dict[n1][n2] for n2 in free_names]
                             for n1 in free_names])
            if not (np.all(np.isfinite(hess)) and np.all(np.isfinite(g))):
                break
            tol_x = 1e-10 * np.maximum(1.0, np.abs(x))
            pinned = (((x <= lo + tol_x) & (g > 0))
                      | ((x >= hi - tol_x) & (g < 0)))
            free = ~pinned
            if not np.any(free):
                break
            g_f = g[free]
            h_f = hess[np.ix_(free, free)]
            diag = np.abs(np.diag(h_f))
            damp = np.diag(np.where(diag > 0, diag, 1.0))
            step_f = None
            for lam in (0.0, 1e-8, 1e-4, 1e-2, 1.0, 1e2):
                try:
                    cand = np.linalg.solve(h_f + lam * damp, -g_f)
                except np.linalg.LinAlgError:
                    continue
                dx = np.zeros(n)
                dx[free] = cand
                x_new = np.clip(x + dx, lo, hi)
                val_new, _ = fun(x_new)
                if val_new <= fval:
                    step_f, x, improved = cand, x_new, fval - val_new
                    fval = float(val_new)
                    break
            if step_f is None:
                break
            # EDM at the undamped limit: g.(H^-1 g)/2 = -g.step/2
            edm = abs(float(g_f @ step_f)) / 2.0
            if edm < ftol or improved < ftol:
                break
        return SimpleNamespace(x=x, fun=fval,
                               success=getattr(result, 'success', True))

    def _solve(self, free_names, params_init, errors, limits, fixed_values,
               polish=True):
        """Run one bounded minimization over free_names; other parameters
        are held at fixed_values. ``polish=False`` (the bias-only
        pre-fit) stops after the first L-BFGS-B pass — stage-1 results
        only seed stage 2, so machine-tight convergence there is
        wasted evaluations."""

        def pack(dct):
            return np.array([dct[name] for name in free_names])

        def unpack(x):
            full = dict(fixed_values)
            full.update({name: float(v) for name, v in zip(free_names, x)})
            return full

        scales = np.array([max(abs(errors.get(n, 0.1)), 1e-8)
                           for n in free_names])

        use_grad = (self.grad_func is not None
                    or self.valgrad_func is not None)
        fused = self.valgrad_func is not None

        if fused:
            # value and gradient from one backward pass: scipy's
            # L-BFGS-B accepts jac=True with fun returning (f, g),
            # halving the per-step device round-trips
            def fun(x):
                val, grads = self.valgrad_func(unpack(x))
                return float(val), np.array(
                    [grads[name] for name in free_names])
        else:
            def fun(x):
                return self._chi2_dict(unpack(x))

        def jac(x):
            grads = self._grad_dict(unpack(x))
            return np.array([grads[name] for name in free_names])

        bounds = []
        for name in free_names:
            lo, hi = limits.get(name, (None, None))
            bounds.append((lo, hi))

        options = {'maxiter': 2000, 'ftol': 1e-13, 'gtol': 1e-10,
                   'maxcor': 30, 'maxls': 60}
        if not use_grad:
            options['eps'] = scales * 1e-4

        newton = polish and fused and self.hess_func is not None
        if newton:
            # Newton polish cleans up below ~1e-9, so the L-BFGS-B pass
            # only needs to deliver the basin, not the last digits
            options = dict(options, ftol=1e-9)

        x0 = pack(params_init)
        result = scipy_minimize(
            fun, x0, jac=True if fused else (jac if use_grad else None),
            bounds=bounds, method='L-BFGS-B', options=options)
        if newton:
            result = self._newton_polish(fun, result, free_names, bounds,
                                         unpack)
        elif polish:
            # Polish: a restart helps L-BFGS-B escape flat curvature
            options = dict(options, ftol=1e-15, gtol=1e-11)
            if not use_grad:
                options['eps'] = scales * 1e-5
            result2 = scipy_minimize(
                fun, result.x,
                jac=True if fused else (jac if use_grad else None),
                bounds=bounds, method='L-BFGS-B', options=options)
            if result2.fun <= result.fun:
                result = result2
        return result, unpack(result.x)

    def _compute_errors(self, free_names, bestfit, fixed_values):
        """Errors and covariance from the Hessian at the minimum:
        cov = 2 H^-1 (errordef = 1 chi^2 convention)."""
        n = len(free_names)
        hesse_failed = False
        if self.hess_func is not None:
            hess_dict = self.hess_func(
                {**fixed_values, **{k: bestfit[k] for k in free_names}},
                free_names)
            hess = np.array(
                [[hess_dict[n1][n2] for n2 in free_names]
                 for n1 in free_names])
        else:
            # Central finite differences of chi2
            hess = np.zeros((n, n))
            steps = np.array([max(abs(bestfit[name]) * 1e-4, 1e-6)
                              for name in free_names])

            def f(x):
                full = dict(fixed_values)
                full.update({name: float(v)
                             for name, v in zip(free_names, x)})
                return self._chi2_dict(full)

            x0 = np.array([bestfit[name] for name in free_names])
            f0 = f(x0)
            for i in range(n):
                for j in range(i, n):
                    hi = np.zeros(n)
                    hj = np.zeros(n)
                    hi[i] = steps[i]
                    hj[j] = steps[j]
                    if i == j:
                        val = (f(x0 + hi) - 2 * f0 + f(x0 - hi)) / steps[i] ** 2
                    else:
                        val = (f(x0 + hi + hj) - f(x0 + hi - hj)
                               - f(x0 - hi + hj) + f(x0 - hi - hj)) / (
                                   4 * steps[i] * steps[j])
                    hess[i, j] = val
                    hess[j, i] = val

        try:
            cov = 2.0 * np.linalg.inv(hess)
            errors = np.sqrt(np.clip(np.diag(cov), 0, None))
            if not np.all(np.isfinite(cov)):
                hesse_failed = True
        except np.linalg.LinAlgError:
            hesse_failed = True
            cov = np.full((n, n), np.nan)
            errors = np.full(n, np.nan)
        return cov, errors, hesse_failed

    # ------------------------------------------------------------------
    def minimize(self, params=None):
        """Two-stage minimization (reference: minimizer.py:39-103)."""
        t0 = time.time()

        params_init = copy.deepcopy(self._sample_params['values'])
        errors = copy.deepcopy(self._sample_params['errors'])
        limits = copy.deepcopy(self._sample_params['limits'])
        fixed = copy.deepcopy(self._sample_params['fix'])

        def write_settings(overrides, name, out_container):
            if name in overrides:
                for par, val in overrides[name].items():
                    out_container[par] = val

        if params is not None:
            write_settings(params, 'values', params_init)
            write_settings(params, 'errors', errors)
            write_settings(params, 'limits', limits)
            write_settings(params, 'fix', fixed)

        all_names = [n for n in self._names]
        fixed_names = [n for n in all_names if fixed.get(n, False)]
        free_names = [n for n in all_names if not fixed.get(n, False)]
        fixed_values = {n: params_init[n] for n in all_names}

        edm = np.nan
        if free_names and self._use_minuit():
            (bestfit, fval, minimum_valid, edm, cov, err_vec,
             hesse_failed) = self._minimize_migrad(
                params_init, errors, limits, fixed_values, free_names)
        else:
            # Stage 1: bias-only pre-fit (reference: minimizer.py:66-86)
            bias_names = [n for n in free_names if 'bias' in n]
            if bias_names and len(bias_names) < len(free_names):
                _, stage1_fit = self._solve(
                    bias_names, params_init, errors, limits, fixed_values,
                    polish=False)
                for name in bias_names:
                    params_init[name] = stage1_fit[name]
                    fixed_values[name] = stage1_fit[name]

            # Stage 2: full fit
            if free_names:
                result, bestfit = self._solve(
                    free_names, params_init, errors, limits, fixed_values)
                minimum_valid = bool(result.success)
                fval = float(result.fun)
            else:
                bestfit = dict(fixed_values)
                minimum_valid = True
                fval = self._chi2_dict(bestfit)

            cov, err_vec, hesse_failed = (
                self._compute_errors(free_names, bestfit, fixed_values)
                if free_names else (np.zeros((0, 0)), np.zeros(0), False))

            # EDM (MINUIT's estimated distance to minimum): with the
            # exact gradient g and Hessian H = 2 cov^-1 in hand,
            # edm = g.(H^-1 g)/2 = g.(cov g)/4 (reference exposes
            # MIGRAD's value, minimizer.py:105-187 via iminuit).
            # Gradient components blocked by an ACTIVE bound are
            # projected out first — at a limit the feasible distance to
            # the minimum is zero along that direction (MIGRAD's
            # internal sin-transform makes its gradient vanish there).
            if free_names and not hesse_failed:
                full = {**fixed_values,
                        **{k: bestfit[k] for k in free_names}}
                g = self._grad_at(full, free_names)
                if g is not None and np.all(np.isfinite(cov)):
                    g = np.array(g, dtype=float)
                    for i, name in enumerate(free_names):
                        lo, hi = limits.get(name, (None, None))
                        x = bestfit[name]
                        tol = 1e-10 * max(1.0, abs(x))
                        if lo is not None and x <= lo + tol and g[i] > 0:
                            g[i] = 0.0
                        if hi is not None and x >= hi - tol and g[i] < 0:
                            g[i] = 0.0
                    edm = float(g @ (cov @ g) / 4.0)

        # Assemble Minuit-compatible results over ALL named parameters
        self._values = {name: float(bestfit[name]) for name in all_names}
        self._errors = {}
        free_err = dict(zip(free_names, err_vec))
        for name in all_names:
            self._errors[name] = float(free_err.get(name, 0.0))

        # Expand covariance to all parameters (zeros for fixed ones)
        full_cov = np.zeros((len(all_names), len(all_names)))
        for i, n1 in enumerate(all_names):
            for j, n2 in enumerate(all_names):
                if n1 in free_names and n2 in free_names:
                    full_cov[i, j] = cov[free_names.index(n1),
                                         free_names.index(n2)]
        self._covariance = CovarianceView(full_cov, all_names)

        self._fmin = SimpleNamespace(
            fval=fval, is_valid=minimum_valid, hesse_failed=hesse_failed,
            edm=edm,
            items=lambda: [('fval', fval), ('is_valid', minimum_valid),
                           ('hesse_failed', hesse_failed), ('edm', edm)])
        self._minuit_shim = SimpleNamespace(
            valid=minimum_valid, accurate=not hesse_failed)

        print(f'INFO: minimized in {time.time() - t0}')
        print(f'INFO: bestfit chi2 = {fval}')
        sys.stdout.flush()
        self.run_flag = True
        del fixed_names

    # ------------------------------------------------------------------
    def _check_run(self):
        if not self.run_flag:
            print('Run Minimizer.minimize() before asking for results')
            raise RuntimeError(
                'Tried to access minimization results before minimization.')

    @property
    def params(self):
        """Per-parameter records (name, value, error)."""
        self._check_run()
        return [SimpleNamespace(name=name, value=self._values[name],
                                error=self._errors[name])
                for name in self._names]

    @property
    def values(self):
        self._check_run()
        return dict(self._values)

    @property
    def errors(self):
        self._check_run()
        return dict(self._errors)

    @property
    def covariance(self):
        self._check_run()
        return self._covariance

    @property
    def fmin(self):
        self._check_run()
        return self._fmin

    @property
    def minuit(self):
        """Minimal shim exposing the .valid / .accurate flags the output
        writer reads (the reference exposes the raw iminuit object)."""
        self._check_run()
        return self._minuit_shim
