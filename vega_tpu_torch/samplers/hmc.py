"""Native Hamiltonian Monte Carlo sampler.

Counterpart of vega_tpu/samplers/hmc.py. The whole chi^2 is
differentiable (torch autograd; on the dense path through the
differentiable spline + Legendre combine), so HMC gets EXACT gradients:
one `chi2_batch_derivatives(..., hessian=False)` call gives every chain's
chi^2 and gradient (rows = chains; the rows are independent, so one
backward pass of chi^2.sum() serves them all), and the logit transform's
log-Jacobian has a closed-form gradient.

Algorithm, as vega_tpu's: standard HMC (Neal 2011) with
- a logit transform to unconstrained space for the uniform-box priors
  (the Jacobian term keeps the target exactly the posterior),
- kick-drift-kick leapfrog with a dense metric,
- dual-averaging step-size adaptation to a target acceptance rate
  (Hoffman & Gelman 2014, Algorithm 5) in three warm-up stages, a dense
  metric estimated from the second half of each of the first two,
- split-R-hat and effective-sample-size diagnostics on the host.

One trajectory (num_leapfrog gradient calls and the Metropolis step for
all chains) is the unit vega_tpu scans over. On a CUDA device it is
captured once per run as a CUDA graph, backward passes included
(`GraphedStep`), and replayed per trajectory; the step size, the
dual-averaging state and the collected draws stay on the device, so a
block of trajectories runs with no host sync. A capture that fails
raises; on a CPU device the same trajectory runs eagerly. The momenta
and the acceptance uniforms come from a torch.Generator seeded with
`seed`: they are not jax.random's, so a chain differs from vega_tpu's
realization by realization. Everything on the device runs in the
likelihood's dtype (f32 under vega_tpu's VEGA_TPU_X64=0, as vega_tpu's
scan does); the host diagnostics take what comes back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.graphs import CapturedGraph
from ..utils import resolve_dtype
from .sampler_interface import Sampler


def make_hmc_step(pot_vg, n_leap):
    """One HMC trajectory for all chains (vega_tpu/samplers/hmc.py:
    133-167, written out over the chains axis).

    pot_vg : (C, ndim) u -> (potential (C,), gradient (C, ndim))

    Returns hmc_step(z, log_unif, u, v, g, eps, inv_mass, chol_mass) ->
    (u, v, g, alpha): z (C, ndim) standard normals (the momentum is
    chol_mass @ z), log_unif (C,) the log of the acceptance uniforms,
    (u, v, g) the chains' positions, potentials and gradients, eps a 0-d
    tensor, inv_mass and chol_mass (ndim, ndim) the dense inverse mass
    matrix and the Cholesky factor of the mass matrix; alpha (C,) the
    acceptance probabilities. Device ops only."""

    def kinetic(p, inv_mass):
        return 0.5 * torch.sum(p * (p @ inv_mass.T), dim=-1)

    def hmc_step(z, log_unif, u, v, g, eps, inv_mass, chol_mass):
        p = z @ chol_mass.T
        h0 = v + kinetic(p, inv_mass)
        # symmetric (kick-drift-kick per step) leapfrog: exactly one
        # gradient evaluation per position step
        u_new, p_new, g_new, v_new = u, p, g, v
        for _ in range(n_leap):
            p_new = p_new - 0.5 * eps * g_new
            u_new = u_new + eps * (p_new @ inv_mass.T)
            v_new, g_new = pot_vg(u_new)
            p_new = p_new - 0.5 * eps * g_new
        h1 = v_new + kinetic(p_new, inv_mass)
        log_alpha = torch.clamp(h0 - h1, max=0.0)
        log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha,
                                -torch.inf)
        accept = log_unif < log_alpha
        u = torch.where(accept[:, None], u_new, u)
        v = torch.where(accept, v_new, v)
        g = torch.where(accept[:, None], g_new, g)
        return u, v, g, torch.exp(log_alpha)

    return hmc_step


class GraphedStep:
    """`hmc_step` for (C, ndim) chains captured as one CUDA graph, the
    backward passes of its gradient calls included, with static buffers
    for every argument and result. Calls take and return what `hmc_step`
    does; the results are the static buffers, overwritten by the next
    call."""

    def __init__(self, hmc_step, state, eps, inv_mass, chol_mass):
        u, v, g = state
        self.args = [torch.zeros_like(u), torch.full_like(v, -1.0),
                     u.clone(), v.clone(), g.clone(), eps.clone(),
                     inv_mass.clone(), chol_mass.clone()]
        self.graph = CapturedGraph(lambda: hmc_step(*self.args), u.device,
                                   warmups=2)

    def __call__(self, *args):
        for static, arg in zip(self.args, args):
            static.copy_(arg)
        return self.graph.replay()


class HMC(Sampler):
    """Batched exact-gradient HMC over the box prior in `limits`.

    Parameters mirror the other native samplers: a config section, the
    prior limits dict, and a likelihood handle. Unlike NS/SMC this
    needs gradients, so it takes the `BatchedLikelihood` (or the bare
    `VegaInterface`) rather than a black-box function, and runs on its
    device. A plain callable still works (the standalone hook): a torch
    function of (chains, ndim) physical values -> (chains,) chi^2 that
    autograd can differentiate, called with tensors on `device`, the card
    unless the caller passes another, in `dtype`: torch.float64 or
    torch.float32, else read from VEGA_TPU_X64 as VegaInterface reads it.
    With an interface the dtype is the interface's.
    """

    def __init__(self, sampler_config, limits, batched_or_vega,
                 derived_dict=None, device='cuda', dtype=None):
        from ..parallel.batch import BatchedLikelihood
        from ..vega_interface import resolve_device

        self._vega = None
        self._chi2_fn = None
        if isinstance(batched_or_vega, BatchedLikelihood):
            self._vega = batched_or_vega.vega
        elif callable(batched_or_vega) and not hasattr(
                batched_or_vega, 'chi2_batch_derivatives'):
            # testing / standalone hook
            self._chi2_fn = batched_or_vega
        else:
            self._vega = batched_or_vega
        if self._vega is not None:
            self.device, self.dtype = self._vega.device, self._vega.dtype
        else:
            self.device = resolve_device(device)
            self.dtype = resolve_dtype(dtype)
        super().__init__(sampler_config, limits,
                         log_lik_func=None, derived_dict=None)

    def write_parnames(self, parnames_path):
        self.derived_dict = None
        self.num_derived = 0
        super().write_parnames(parnames_path)

    def get_sampler_settings(self, sampler_config, num_params, num_derived):
        self.num_chains = sampler_config.getint('num_chains', 32)
        self.num_samples = sampler_config.getint('num_samples', 1000)
        self.num_warmup = sampler_config.getint('num_warmup', 500)
        self.num_leapfrog = sampler_config.getint('num_leapfrog', 16)
        self.target_accept = sampler_config.getfloat('target_accept', 0.8)
        self.initial_step = sampler_config.getfloat('initial_step', 0.1)
        self.seed = sampler_config.getint('seed', 0)
        self.thin = sampler_config.getint('thin', 1)

    # ------------------------------------------------------------------
    def _build_potential(self):
        """pot_vg(u) -> (U, dU/du) for (C, ndim) chains on the
        unconstrained space, U(u) = chi2(x(u))/2 - log|dx/du|
        (vega_tpu/samplers/hmc.py:77-114; its gradient written out
        instead of traced)."""
        names = list(self.names)
        lo = torch.tensor([self.limits[n][0] for n in names],
                          dtype=self.dtype, device=self.device)
        span = torch.tensor([self.limits[n][1] for n in names],
                            dtype=self.dtype, device=self.device) - lo

        if self._chi2_fn is not None:
            def chi2_and_gradient(x):
                with torch.enable_grad():
                    x = x.detach().requires_grad_(True)
                    chi2 = self._chi2_fn(x)
                    grad, = torch.autograd.grad(chi2.sum(), x)
                return chi2.detach(), grad
        else:
            def chi2_and_gradient(x):
                return self._vega.chi2_batch_derivatives(
                    names, x, hessian=False)[:2]

        def pot_vg(u):
            sig = torch.sigmoid(u)
            chi2, grad_x = chi2_and_gradient(lo + span * sig)
            # log|dx/du| for the logit transform (uniform box prior),
            # and its gradient 1 - 2 sigmoid(u)
            log_jac = torch.sum(torch.log(span) + F.logsigmoid(u)
                                + F.logsigmoid(-u), dim=-1)
            grad = (0.5 * grad_x * span * sig * (1.0 - sig)
                    - (1.0 - 2.0 * sig))
            return 0.5 * chi2 - log_jac, grad

        return pot_vg

    def _to_physical(self, u):
        lo = np.array([self.limits[n][0] for n in self.names])
        hi = np.array([self.limits[n][1] for n in self.names])
        return lo + (hi - lo) / (1.0 + np.exp(-np.asarray(u)))

    # ------------------------------------------------------------------
    def _run_block(self, step, generator, state, inv_mass, chol_mass,
                   n_iters, adapt, log_eps, da_state):
        """`n_iters` trajectories for all chains, with dual-averaging
        adaptation of the step size when `adapt`
        (vega_tpu/samplers/hmc.py:173-199). The random numbers of the
        block are drawn first; log_eps and da_state = (h_bar,
        log_eps_bar, mu) are 0-d device tensors, and nothing in the loop
        waits for the device. Returns ((state, log_eps, da_state), us
        (n_iters, C, ndim), vs (n_iters, C), accs (n_iters,))."""
        u, v, g = state
        n_chains, ndim = u.shape
        z = torch.randn((n_iters, n_chains, ndim), generator=generator,
                        dtype=self.dtype, device=self.device)
        log_unif = torch.log(torch.rand((n_iters, n_chains),
                                        generator=generator, dtype=self.dtype,
                                        device=self.device))
        us = torch.empty((n_iters, n_chains, ndim), dtype=self.dtype,
                         device=self.device)
        vs = torch.empty((n_iters, n_chains), dtype=self.dtype,
                         device=self.device)
        accs = torch.empty(n_iters, dtype=self.dtype, device=self.device)
        h_bar, log_eps_bar, mu = da_state
        delta = self.target_accept
        for it in range(n_iters):
            u, v, g, alpha = step(z[it], log_unif[it], u, v, g,
                                  torch.exp(log_eps), inv_mass, chol_mass)
            a_mean = torch.mean(alpha)
            if adapt:
                m = it + 1.0
                h_bar = ((1.0 - 1.0 / (m + 10.0)) * h_bar
                         + (delta - a_mean) / (m + 10.0))
                log_eps = mu - np.sqrt(m) / 0.05 * h_bar
                w = m ** -0.75
                log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            us[it] = u
            vs[it] = v
            accs[it] = a_mean
        state = (u.clone(), v.clone(), g.clone())
        return (state, log_eps, (h_bar, log_eps_bar, mu)), us, vs, accs

    def _build_step(self, pot_vg, state, log_eps, inv_mass, chol_mass):
        """One trajectory for all chains: `hmc_step` itself, or on a CUDA
        device its CUDA graph."""
        step = make_hmc_step(pot_vg, self.num_leapfrog)
        if self.device.type == 'cuda':
            step = GraphedStep(step, state, torch.exp(log_eps), inv_mass,
                               chol_mass)
        return step

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self):
        ndim = self.num_params
        rng = np.random.default_rng(self.seed)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed)

        def tensor(values):
            return torch.as_tensor(np.asarray(values, dtype=np.float64),
                                   dtype=self.dtype, device=self.device)

        # start chains jittered around the configured parameter values
        # (the reference's standard fit starting point): far better
        # than uniform-over-the-box starts when the posterior is a
        # narrow ridge inside a wide prior
        lo = np.array([self.limits[n][0] for n in self.names])
        hi = np.array([self.limits[n][1] for n in self.names])
        if self._vega is not None and hasattr(self._vega, 'params'):
            x0 = np.array([float(self._vega.params.get(n, 0.5 * (l + h)))
                           for n, l, h in zip(self.names, lo, hi)])
        else:
            x0 = 0.5 * (lo + hi)
        unit0 = np.clip((x0 - lo) / (hi - lo), 0.02, 0.98)
        u_center = np.log(unit0 / (1.0 - unit0))
        u0 = tensor(u_center + 0.3 * rng.standard_normal((self.num_chains,
                                                          ndim)))

        inv_mass = torch.eye(ndim, dtype=self.dtype, device=self.device)
        chol_mass = torch.eye(ndim, dtype=self.dtype, device=self.device)
        log_eps = tensor(np.log(self.initial_step))

        pot_vg = self._build_potential()
        v0, g0 = pot_vg(u0)
        state = (u0, v0, g0)
        step = self._step = self._build_step(pot_vg, state, log_eps,
                                             inv_mass, chol_mass)

        def mass_from(us_tail):
            """Dense (regularized) metric from warmup u-samples."""
            flat = us_tail.reshape(-1, ndim)
            cov = np.atleast_2d(np.cov(flat, rowvar=False))
            n = flat.shape[0]
            w = n / (n + 5.0)
            cov = w * cov + (1.0 - w) * np.diag(
                np.maximum(np.diag(cov), 1e-3))
            cov += 1e-10 * np.trace(cov) / ndim * np.eye(ndim)
            mass = np.linalg.inv(cov)
            return tensor(cov), tensor(np.linalg.cholesky(mass))

        def da_start(log_eps):
            return (torch.zeros((), dtype=self.dtype, device=self.device),
                    log_eps, log_eps + np.log(10.0))

        # Stan-style windowed warmup: three dual-averaging stages with
        # a dense-metric update after each of the first two
        n_total = max(self.num_warmup, 20)
        stages = [max(5, n_total // 4), max(5, n_total // 2),
                  max(5, n_total // 4)]
        for i, n_stage in enumerate(stages):
            carry, us, _, accs = self._run_block(
                step, generator, state, inv_mass, chol_mass, n_stage, True,
                log_eps, da_start(log_eps))
            state, _, (_, log_eps, _) = carry
            if i < len(stages) - 1:
                inv_mass, chol_mass = mass_from(
                    us.cpu().numpy()[n_stage // 2:])

        eps = float(torch.exp(log_eps))

        # Sampling at fixed (eps, metric)
        carry, us, vs, accs = self._run_block(
            step, generator, state, inv_mass, chol_mass, self.num_samples,
            False, log_eps, da_start(log_eps))

        us = us.cpu().numpy()[::self.thin]        # (draws, chains, ndim)
        vs = vs.cpu().numpy()[::self.thin]
        accept_rate = float(np.mean(accs.cpu().numpy()))

        r_hat = self._split_r_hat(us)
        ess = self._effective_sample_size(us)

        draws = us.reshape(-1, ndim)
        samples = self._to_physical(draws)
        # potential = -log posterior + const; report log-posterior
        logp = -vs.reshape(-1)

        self.write_chain(samples, np.ones(len(samples)), logp)
        self.results = {
            'samples': samples,
            'logp': logp,
            'accept_rate': accept_rate,
            'step_size': eps,
            'inv_mass': inv_mass.cpu().numpy(),
            'r_hat': r_hat,
            'ess': ess,
            'names': list(self.names),
        }
        print(f'HMC: accept {accept_rate:.2f}, step {eps:.3g}, '
              f'max R-hat {np.max(r_hat):.3f}, min ESS {np.min(ess):.0f}')
        return self.results

    # ------------------------------------------------------------------
    @staticmethod
    def _split_r_hat(chains):
        """Split-R-hat per dimension; chains: (draws, n_chains, ndim)."""
        n = chains.shape[0] // 2 * 2
        halves = np.concatenate(np.split(chains[:n], 2, axis=0), axis=1)
        m, ndraw = halves.shape[1], halves.shape[0]
        means = halves.mean(axis=0)                       # (m, ndim)
        b = ndraw * means.var(axis=0, ddof=1)
        w = halves.var(axis=0, ddof=1).mean(axis=0)
        var_plus = (ndraw - 1) / ndraw * w + b / ndraw
        return np.sqrt(var_plus / np.maximum(w, 1e-300))

    @staticmethod
    def _effective_sample_size(chains):
        """Crude per-dimension ESS from lag-autocorrelation (Geyer
        initial positive sequence, pooled over chains)."""
        draws, m, ndim = chains.shape
        ess = np.zeros(ndim)
        for d in range(ndim):
            x = chains[:, :, d] - chains[:, :, d].mean(axis=0)
            # mean autocorrelation over chains
            acf_len = min(draws - 1, 200)
            rho = np.zeros(acf_len)
            var = (x * x).mean()
            for lag in range(1, acf_len + 1):
                rho[lag - 1] = (x[:-lag] * x[lag:]).mean() / var
            # truncate at first negative
            neg = np.where(rho < 0)[0]
            cut = neg[0] if len(neg) else acf_len
            tau = 1.0 + 2.0 * rho[:cut].sum()
            ess[d] = draws * m / max(tau, 1.0)
        return ess
