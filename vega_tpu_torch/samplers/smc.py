"""Native Sequential Monte Carlo sampler.

Counterpart of vega_tpu/samplers/smc.py, which replaces the reference's
PocoMC dependency with an adaptive-tempering SMC whose particle
population moves through batched likelihood calls. The loop is host numpy
with numpy random numbers, copied: with the same seed and a likelihood
that returns the same values it gives vega_tpu's chain bit for bit. Each
rejuvenation step is one batched likelihood call of n_effective rows on
the likelihood's device.

Algorithm: anneal from the prior (beta = 0) to the posterior (beta = 1);
at each stage pick the next beta so the effective sample size stays at
ess_target (bisection), resample, then rejuvenate the particles with a
few covariance-adapted random-walk MCMC steps (each step = one batched
likelihood call). The evidence follows from the incremental weights.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .sampler_interface import Sampler, host_array


class SMCSampler(Sampler):
    """Adaptive-tempering SMC with uniform priors."""

    def get_sampler_settings(self, sampler_config, num_params, num_derived):
        self.n_particles = sampler_config.getint('n_effective', 512)
        self.n_mcmc = sampler_config.getint('n_mcmc', 5)
        self.ess_target = sampler_config.getfloat('ess_target', 0.8)
        self.seed = sampler_config.getint('seed', 0)
        self.max_stages = sampler_config.getint('max_stages', 200)
        # state dumps every N stages (the PocoMC save_every equivalent)
        self.save_every = sampler_config.getint('save_every', 3)
        self.resume = sampler_config.getboolean('resume', True)
        self.checkpoint_path = Path(self.path) / (self.name + '.smc.npz')

    def _batch_log_lik(self, theta):
        params = {name: theta[:, i] for i, name in enumerate(self.names)}
        return host_array(self.log_lik(params))

    @staticmethod
    def _ess_fraction(log_w):
        w = np.exp(log_w - np.max(log_w))
        w /= w.sum()
        return 1.0 / np.sum(w ** 2) / len(w)

    def _next_beta(self, logl, beta):
        """Largest next beta keeping ESS above the target (bisection)."""
        lo, hi = beta, 1.0
        if self._ess_fraction((hi - beta) * logl) >= self.ess_target:
            return 1.0
        for _ in range(60):
            mid = (lo + hi) / 2
            if self._ess_fraction((mid - beta) * logl) >= self.ess_target:
                lo = mid
            else:
                hi = mid
        return lo

    def run(self):
        rng = np.random.default_rng(self.seed)
        ndim = self.num_params
        n = self.n_particles

        if self.resume and self.checkpoint_path.exists():
            print(f'Resuming SMC from {self.checkpoint_path}')
            state = dict(np.load(self.checkpoint_path))
            u = state['u']
            logl = state['logl']
            beta = float(state['beta'])
            log_z = float(state['log_z'])
            stage = int(state['stage'])
        else:
            u = rng.uniform(size=(n, ndim))
            logl = self._batch_log_lik(self.prior_transform(u))
            beta = 0.0
            log_z = 0.0
            stage = 0

        while beta < 1.0 and stage < self.max_stages:
            beta_new = self._next_beta(logl, beta)
            dlog_w = (beta_new - beta) * logl
            log_z += (np.logaddexp.reduce(dlog_w) - np.log(n))

            # Systematic resampling
            w = np.exp(dlog_w - np.max(dlog_w))
            w /= w.sum()
            positions = (rng.uniform() + np.arange(n)) / n
            idx = np.searchsorted(np.cumsum(w), positions)
            u = u[idx]
            logl = logl[idx]
            beta = beta_new

            # Rejuvenate with covariance-adapted random walk at temperature
            # beta; each MCMC step is one batched likelihood call
            cov = np.cov(u, rowvar=False) + 1e-12 * np.eye(ndim)
            chol = np.linalg.cholesky(cov)
            scale = 2.38 / np.sqrt(ndim)
            n_accept = 0
            for _ in range(self.n_mcmc):
                prop = u + rng.normal(size=(n, ndim)) @ chol.T * scale
                inside = np.all((prop > 0) & (prop < 1), axis=1)
                prop_c = np.clip(prop, 1e-12, 1 - 1e-12)
                logl_prop = self._batch_log_lik(self.prior_transform(prop_c))
                log_alpha = beta * (logl_prop - logl)
                accept = inside & (np.log(rng.uniform(size=n)) < log_alpha)
                u = np.where(accept[:, None], prop_c, u)
                logl = np.where(accept, logl_prop, logl)
                n_accept += accept.sum()
            acc_rate = n_accept / (n * self.n_mcmc)
            stage += 1
            print(f'SMC stage {stage}: beta = {beta:.4f}, '
                  f'logZ = {log_z:.4f}, acc = {acc_rate:.2f}')
            if stage % self.save_every == 0 or beta >= 1.0:
                np.savez(self.checkpoint_path, u=u, logl=logl, beta=beta,
                         log_z=log_z, stage=stage)

        samples = self.prior_transform(u)
        weights = np.full(n, 1.0 / n)
        self.write_chain(samples, weights, logl)

        stats_path = Path(self.path) / (self.name + '.stats')
        with open(stats_path, 'w') as f:
            f.write(f'logZ = {log_z}\n')
            f.write(f'num_stages = {stage}\n')
        print(f'log(Z) = {log_z}')

        return {'samples': samples, 'weights': weights, 'loglikes': logl,
                'logz': log_z}
