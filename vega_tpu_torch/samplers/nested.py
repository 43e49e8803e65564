"""Native batched nested sampler.

Counterpart of vega_tpu/samplers/nested.py, which replaces the
reference's PolyChord dependency with a single-controller nested-sampling
loop whose likelihood work is one batch per call:

- K worst live points are replaced per iteration (batched kill).
- Replacements evolve by constrained slice sampling (PolyChord's
  proposal mechanism: whitened random directions + interval shrinkage;
  Neal 2003 "shrinkage procedure") started from random survivors; all K
  chains step together, so each slice step is ONE batched likelihood
  call. `proposal = rwm` falls back to adaptive random-walk Metropolis.
- Evidence from the standard shrinkage estimate ln X_i ~ -i / n_live.
- Checkpoint/resume via npz state dumps, in vega_tpu's format.

The host loop (numpy arithmetic, numpy random numbers) is copied: with
the same seed and a likelihood that returns the same values it gives
vega_tpu's chain bit for bit. The fused evolution is `DeviceEvolve`: one
function of device tensors, replayed as one CUDA graph per NS iteration.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..ops.graphs import CapturedGraph
from .sampler_interface import Sampler, host_array


def slice_evolve(log_lik_u, u0, l_min, width, chol, normals, offsets,
                 shrinks):
    """Constrained slice evolution of n chains on the unit cube, as
    device ops only (vega_tpu/samplers/nested.py:210-254): fixed trip
    counts, and a chain that has accepted goes on evaluating masked no-op
    proposals (t = 0) until the shrink steps run out.

    log_lik_u : (n, ndim) unit-cube tensor -> (n,) log-likelihoods
    u0 : (n, ndim) starts; l_min, width : 0-d tensors (the likelihood
        constraint and the bracket width); chol : (ndim, ndim) Cholesky
        factor of the live points' covariance
    normals : (R, n, ndim) standard normals, a direction per repeat
    offsets : (R, n) uniforms in [0, 1), the bracket's position
    shrinks : (R, S, n) uniforms in [0, 1), scaled to (left, right)

    Returns (u, logl, steps, moves): the evolved points, their
    log-likelihoods, and the 0-d int64 counts of shrink steps taken by
    chains not yet done and of accepted moves. No host sync inside."""
    n = u0.shape[0]
    u, logl = u0, log_lik_u(u0)
    steps = torch.zeros((), dtype=torch.int64, device=u0.device)
    moves = torch.zeros((), dtype=torch.int64, device=u0.device)
    for r in range(normals.shape[0]):
        d = normals[r] @ chol.T
        left = -width * offsets[r]
        right = left + width
        done = torch.zeros(n, dtype=torch.bool, device=u0.device)
        for s in range(shrinks.shape[1]):
            t = left + (right - left) * shrinks[r, s]
            t = torch.where(done, 0.0, t)
            prop = u + t[:, None] * d
            inside = ((prop > 0) & (prop < 1)).all(dim=1)
            prop_c = torch.clamp(prop, 1e-12, 1 - 1e-12)
            logl_prop = log_lik_u(prop_c)
            ok = inside & (logl_prop > l_min) & ~done
            u = torch.where(ok[:, None], prop, u)
            logl = torch.where(ok, logl_prop, logl)
            steps = steps + (~done).sum()
            done = done | ok
            # shrink the bracket towards the current point for chains
            # that rejected
            rej = ~done
            left = torch.where(rej & (t < 0), t, left)
            right = torch.where(rej & (t >= 0), t, right)
        moves = moves + done.sum()
    return u, logl, steps, moves


class DeviceEvolve:
    """One NS iteration's slice evolution for n chains as one dispatch on
    the likelihood's device (vega_tpu/samplers/nested.py:183-283, one
    jitted fori_loop there).

    `slice_evolve` runs around `BatchedLikelihood.traceable_log_lik`. The
    random numbers are an input, drawn before the call from a
    torch.Generator on the device seeded seed * 1_000_003 + it: they are
    not jax.random's, so a chain differs from vega_tpu's realization by
    realization while targeting the same constrained distribution. The
    inputs, the random numbers and the packed results are in the
    likelihood's dtype, as vega_tpu's jitted evolve holds them (f32 under
    VEGA_TPU_X64=0, where the clamp's 1 - 1e-12 is 1.0 in both packages).
    On a CUDA device the function is captured once in a
    torch.cuda.CUDAGraph with static input and output buffers and
    replayed once per call: the host inputs go up in one copy, the four
    results come back in one. A
    capture or replay that fails raises; nothing falls back to the host
    loop. On a CPU device the same function runs eagerly."""

    def __init__(self, batched, names, limits, n, num_repeats, max_shrink,
                 seed):
        self.log_lik = batched.traceable_log_lik(names)
        self.device = batched.vega.device
        self.dtype = batched.vega.dtype
        self.n, self.ndim = int(n), len(names)
        self.seed = seed

        def tensor(values):
            return torch.tensor(values, dtype=self.dtype,
                                device=self.device)

        lo = tensor([limits[name][0] for name in names])
        span = tensor([limits[name][1] for name in names]) - lo
        self.log_lik_u = lambda u: self.log_lik(lo + u * span)
        self.generator = torch.Generator(device=self.device)
        # static buffers: the host inputs (u0, l_min, width, chol) in one
        # flat tensor, the random numbers, and the packed results
        n_u, n_c = self.n * self.ndim, self.ndim ** 2
        self._host_in = torch.empty(n_u + 2 + n_c, dtype=self.dtype,
                                    pin_memory=self.device.type == 'cuda')
        self._in = torch.empty(n_u + 2 + n_c, dtype=self.dtype,
                               device=self.device)
        self.inputs = (self._in[:n_u].view(self.n, self.ndim),
                       self._in[n_u], self._in[n_u + 1],
                       self._in[n_u + 2:].view(self.ndim, self.ndim))
        self.randoms = tuple(
            torch.empty(shape, dtype=self.dtype, device=self.device)
            for shape in ((num_repeats, self.n, self.ndim),
                          (num_repeats, self.n),
                          (num_repeats, max_shrink, self.n)))
        self.graph = None
        if self.device.type == 'cuda':
            # a run on placeholder inputs warms up, a second is captured
            self._in.zero_()
            self.inputs[0].fill_(0.5)
            self.inputs[3].copy_(torch.eye(self.ndim, dtype=self.dtype))
            self.draw(0)
            self.graph = CapturedGraph(self.evolve, self.device)

    def stale(self, n):
        """True when this function cannot serve a batch of n chains: it
        was built for another n, or the likelihood's data vectors have
        changed since (the captured graph reads the old ones)."""
        return n != self.n or self.log_lik.stale()

    def evolve(self):
        """`slice_evolve` on the static inputs, results packed as one
        (n ndim + n + 2,) tensor of the likelihood's dtype: u, logl,
        steps, moves (the counts exact up to 2^24 in f32: an iteration
        takes at most n num_repeats max_shrink steps)."""
        u, logl, steps, moves = slice_evolve(self.log_lik_u, *self.inputs,
                                             *self.randoms)
        return torch.cat([u.reshape(-1), logl,
                          torch.stack([steps, moves]).to(self.dtype)])

    def draw(self, it):
        """Fill the static random-number buffers for iteration `it`."""
        self.generator.manual_seed(self.seed * 1_000_003 + it)
        normals, offsets, shrinks = self.randoms
        normals.normal_(generator=self.generator)
        offsets.uniform_(generator=self.generator)
        shrinks.uniform_(generator=self.generator)

    def load(self, start_u, l_min, width, chol):
        """Copy the host inputs into their static buffer, in one copy (the
        f64 host values rounded to the buffer's dtype)."""
        n_u = self.n * self.ndim
        host = self._host_in.numpy()
        host[:n_u] = np.asarray(start_u, dtype=np.float64).reshape(-1)
        host[n_u] = l_min
        host[n_u + 1] = width
        host[n_u + 2:] = np.asarray(chol, dtype=np.float64).reshape(-1)
        self._in.copy_(self._host_in, non_blocking=True)

    def run(self, graph=True):
        """One evolution on the loaded inputs and drawn random numbers:
        the packed results, still on the device. graph=False runs the
        same function eagerly on a CUDA device (to compare and time the
        two); a CPU device has no graph."""
        if self.graph is None or not graph:
            return self.evolve()
        return self.graph.replay()

    def __call__(self, start_u, l_min, width, chol, it):
        """(u (n, ndim), logl (n,), steps, moves): u and logl as host
        numpy arrays of the likelihood's dtype, as vega_tpu's evolve
        returns them."""
        self.load(start_u, l_min, width, chol)
        self.draw(it)
        out = self.run().cpu().numpy()
        n_u = self.n * self.ndim
        return (out[:n_u].reshape(self.n, self.ndim),
                out[n_u:n_u + self.n], int(out[-2]), int(out[-1]))


class NestedSampler(Sampler):
    """Batched nested sampler with uniform priors.

    Accepts either a plain host callable ``log_lik_func`` (dict of
    parameter batches -> log L array) or a
    ``vega_tpu_torch.parallel.BatchedLikelihood`` instance. With the
    latter, the ENTIRE per-iteration slice evolution (num_repeats
    direction draws x max_shrink constrained shrink steps, each a batched
    likelihood) runs as ONE dispatch on the likelihood's device
    (``device_loop = True``, the default; `DeviceEvolve`). The host-driven
    loop makes one batched likelihood call per shrink step, each a
    stream of some hundred small kernels that the host cannot launch as
    fast as the device runs them. The fused path draws its random numbers
    from a torch generator (seeded from the sampler seed + iteration), so
    chains differ realization-by-realization from the host path while
    targeting the identical constrained distribution:
    tests/test_torch_samplers.py asserts posterior/evidence agreement.
    ``device_loop = False`` (or VEGA_TPU_NS_DEVICE_LOOP=0) asks for the
    host loop; nothing else selects it.
    """

    def __init__(self, sampler_config, limits, log_lik_func,
                 derived_dict=None):
        from ..parallel.batch import BatchedLikelihood

        self._batched = None
        if isinstance(log_lik_func, BatchedLikelihood):
            self._batched = log_lik_func
            log_lik_func = self._batched.log_lik
        super().__init__(sampler_config, limits, log_lik_func,
                         derived_dict=derived_dict)

    def write_parnames(self, parnames_path):
        """The native sampler's chains carry only the sampled parameters
        (PolyChord appends marginalization coefficients as derived
        columns; here they are obtained in post-processing via
        VegaInterface.compute_marg_coeff), so the .paramnames file must
        match the chain columns."""
        self.derived_dict = None
        self.num_derived = 0
        super().write_parnames(parnames_path)

    def get_sampler_settings(self, sampler_config, num_params, num_derived):
        self.num_live = sampler_config.getint('num_live', 25 * num_params)
        self.num_repeats = sampler_config.getint('num_repeats',
                                                 5 * num_params)
        self.precision = sampler_config.getfloat('precision', 1e-3)
        self.batch_size = sampler_config.getint(
            'batch_size', max(1, self.num_live // 4))
        self.max_iters = sampler_config.getint('max_iters', 100000)
        self.seed = sampler_config.getint('seed', 0)
        self.proposal = sampler_config.get('proposal', 'slice').lower()
        self.max_shrink = sampler_config.getint('max_shrink', 12)
        self.resume = sampler_config.getboolean('resume', True)
        self.checkpoint_every = sampler_config.getint('checkpoint_every', 50)
        self.checkpoint_path = Path(self.path) / (self.name + '.resume.npz')
        self.device_loop = sampler_config.getboolean(
            'device_loop',
            os.environ.get('VEGA_TPU_NS_DEVICE_LOOP', '1') == '1')
        self._evolve_fn = None

    # ------------------------------------------------------------------
    def _batch_log_lik(self, theta):
        """theta: (n, ndim) physical parameters -> (n,) log L."""
        params = {name: theta[:, i] for i, name in enumerate(self.names)}
        self._n_evals = getattr(self, '_n_evals', 0) + theta.shape[0]
        return host_array(self.log_lik(params))

    def _mcmc_evolve(self, start, l_min, scale, rng):
        """Evolve a batch of points with constrained random-walk MCMC.

        All chains move together: each of the num_repeats steps is one
        batched likelihood evaluation.
        """
        n, ndim = start.shape
        theta = start.copy()
        logl = self._batch_log_lik(self.prior_transform(theta))
        n_accept = np.zeros(n)

        cov = np.cov(self.live_u, rowvar=False)
        cov += 1e-12 * np.eye(ndim)
        chol = np.linalg.cholesky(cov)

        for _ in range(self.num_repeats):
            step = rng.normal(size=(n, ndim)) @ chol.T * scale
            prop = theta + step
            inside = np.all((prop > 0) & (prop < 1), axis=1)
            prop = np.clip(prop, 1e-12, 1 - 1e-12)
            logl_prop = self._batch_log_lik(self.prior_transform(prop))
            accept = inside & (logl_prop > l_min)
            theta = np.where(accept[:, None], prop, theta)
            logl = np.where(accept, logl_prop, logl)
            n_accept += accept
        accept_rate = n_accept.mean() / self.num_repeats
        return theta, logl, accept_rate

    def _slice_evolve(self, start, l_min, width, rng):
        """Evolve a batch of points with constrained slice sampling.

        Each of the num_repeats repeats draws one random direction per
        chain from the live-point covariance (whitened slice directions,
        as in PolyChord) and performs interval shrinkage on the hard
        constraint L > l_min. All chains shrink together, so every
        shrink step is ONE batched likelihood call. Shrinkage from a
        randomly positioned fixed-width interval is a valid slice
        update (Neal 2003, Fig. 5 procedure without stepping-out).

        Returns (theta, logl, mean shrink steps per accepted move).
        """
        n, ndim = start.shape
        theta = start.copy()
        logl = self._batch_log_lik(self.prior_transform(theta))

        cov = np.cov(self.live_u, rowvar=False)
        cov += 1e-12 * np.eye(ndim)
        chol = np.linalg.cholesky(cov)

        total_steps = 0.0
        total_moves = 0.0
        for _ in range(self.num_repeats):
            d = rng.normal(size=(n, ndim)) @ chol.T
            u0 = rng.uniform(size=n)
            left = -width * u0
            right = left + width
            done = np.zeros(n, dtype=bool)
            for _step in range(self.max_shrink):
                t = rng.uniform(left, right)
                t = np.where(done, 0.0, t)
                prop = theta + t[:, None] * d
                inside = np.all((prop > 0) & (prop < 1), axis=1)
                prop_c = np.clip(prop, 1e-12, 1 - 1e-12)
                logl_prop = self._batch_log_lik(self.prior_transform(prop_c))
                ok = inside & (logl_prop > l_min) & ~done
                theta = np.where(ok[:, None], prop, theta)
                logl = np.where(ok, logl_prop, logl)
                total_steps += float(np.sum(~done))
                done |= ok
                # shrink the bracket towards the current point for
                # chains that rejected
                rej = ~done
                left = np.where(rej & (t < 0), t, left)
                right = np.where(rej & (t >= 0), t, right)
                if done.all():
                    break
            total_moves += float(done.sum())
        mean_steps = total_steps / max(total_moves, 1.0)
        return theta, logl, mean_steps

    # ------------------------------------------------------------------
    def _build_device_evolve(self, n):
        """The whole slice evolution of one NS iteration as one dispatch
        (`DeviceEvolve`), for batches of n chains."""
        return DeviceEvolve(self._batched, self.names, self.limits, n,
                            int(self.num_repeats), int(self.max_shrink),
                            self.seed)

    def _slice_evolve_device(self, start, l_min, width, rng, it):
        """Fused on-device slice evolution (see DeviceEvolve)."""
        del rng                      # the device path draws from torch
        if self._evolve_fn is None or self._evolve_fn.stale(start.shape[0]):
            self._evolve_fn = self._build_device_evolve(start.shape[0])
        cov = np.cov(self.live_u, rowvar=False)
        cov += 1e-12 * np.eye(start.shape[1])
        chol = np.linalg.cholesky(cov)
        u, logl, steps, moves = self._evolve_fn(start, l_min, width, chol,
                                                it)
        # every proposal row is evaluated on device (masked rows
        # included) plus the seed-point evaluation
        self._n_evals = (getattr(self, '_n_evals', 0)
                         + start.shape[0] * (1 + self.num_repeats
                                             * self.max_shrink))
        mean_steps = float(steps) / max(float(moves), 1.0)
        return u, logl, mean_steps

    # ------------------------------------------------------------------
    @staticmethod
    def _bootstrap_logz_err(dead_logl, dead_neff, live_logl_sorted,
                            rng, n_boot=200):
        """Evidence uncertainty by bootstrapping the shrinkage volumes.

        Each realization draws the per-removal compression factors
        t_i = U^(1/n_eff_i) (the order-statistics distribution of the
        largest of n_eff uniform volumes), accumulates the trapezoid
        weights w_i = X_{i-1} - X_i, adds the final live-point block at
        equal shares of the remaining volume, and recomputes logZ. The
        reported error is the standard deviation over realizations.
        """
        from scipy.special import logsumexp

        n_dead = dead_logl.size
        n_live = live_logl_sorted.size
        if n_dead == 0:
            return np.inf
        logz_samples = np.empty(n_boot)
        for b in range(n_boot):
            ln_t = np.log(rng.uniform(size=n_dead)) / dead_neff
            ln_x = np.cumsum(ln_t)                  # X_i after removal i
            ln_x_prev = np.concatenate([[0.0], ln_x[:-1]])
            # ln(X_{i-1} - X_i), stable in log space
            ln_w = ln_x_prev + np.log(-np.expm1(ln_x - ln_x_prev))
            logz_b = logsumexp(ln_w + dead_logl)
            if n_live:
                logz_b = np.logaddexp(logz_b, logsumexp(
                    ln_x[-1] - np.log(n_live) + live_logl_sorted))
            logz_samples[b] = logz_b
        return float(np.std(logz_samples))

    def run(self):
        """Run the nested-sampling loop; returns a results dict and writes
        the getdist chain + a stats file."""
        rng = np.random.default_rng(self.seed)
        ndim = self.num_params

        state = None
        if self.resume and self.checkpoint_path.exists():
            print(f'Resuming from {self.checkpoint_path}')
            state = dict(np.load(self.checkpoint_path))

        if state is None:
            self.live_u = rng.uniform(size=(self.num_live, ndim))
            live_logl = self._batch_log_lik(self.prior_transform(self.live_u))
            dead_u = np.empty((0, ndim))
            dead_logl = np.empty(0)
            log_x = 0.0
            log_z = -np.inf
            it = 0
            scale = 2.0 if self.proposal == 'slice' else 0.5
        else:
            self.live_u = state['live_u']
            live_logl = state['live_logl']
            dead_u = state['dead_u']
            dead_logl = state['dead_logl']
            log_x = float(state['log_x'])
            log_z = float(state['log_z'])
            it = int(state['it'])
            scale = float(state['scale'])

        k = min(self.batch_size, self.num_live - 1)
        dead_logw = list(np.atleast_1d(state['dead_logw'])) if state is not None \
            else []
        # effective live count at each removal — the shrinkage
        # distribution per dead point, kept for the bootstrap evidence
        # error (t_i ~ Beta(n_eff, 1)); absent in pre-existing resume
        # files, in which case the bootstrap falls back to n_eff = N
        if state is not None and 'dead_neff' in state:
            dead_neff = list(np.atleast_1d(state['dead_neff']))
        else:
            dead_neff = [float(self.num_live)] * len(dead_logw)

        while it < self.max_iters:
            order = np.argsort(live_logl)
            worst = order[:k]
            l_min = live_logl[worst[-1]]

            # Shrinkage for the k simultaneous kills. Order statistics of
            # uniform volumes: the j-th of k removals (no replacement until
            # the batch completes) shrinks by E[dlnX] = -1/(N-j), so the
            # batch total matches E[ln U_(N-k)] = -(psi(N+1) - psi(N-k+1)).
            for j in range(k):
                n_eff = self.num_live - j
                logw = log_x + np.log(-np.expm1(-1.0 / n_eff))
                dead_logw.append(logw + live_logl[worst[j]])
                dead_neff.append(float(n_eff))
                log_z = np.logaddexp(log_z, logw + live_logl[worst[j]])
                log_x = log_x - 1.0 / n_eff

            dead_u = np.vstack([dead_u, self.live_u[worst]])
            dead_logl = np.concatenate([dead_logl, live_logl[worst]])

            # Replace killed points from random survivors
            survivors = order[k:]
            seeds = survivors[rng.integers(0, len(survivors), size=k)]
            if self.proposal == 'slice':
                if self._batched is not None and self.device_loop:
                    new_u, new_logl, diag = self._slice_evolve_device(
                        self.live_u[seeds], l_min, scale, rng, it)
                else:
                    new_u, new_logl, diag = self._slice_evolve(
                        self.live_u[seeds], l_min, scale, rng)
                # Adapt the bracket width towards ~2-3 shrink steps
                # per slice move
                if diag > 4.0:
                    scale = max(scale * 0.85, 0.2)
                elif diag < 1.5:
                    scale = min(scale * 1.3, 10.0)
            else:
                new_u, new_logl, diag = self._mcmc_evolve(
                    self.live_u[seeds], l_min, scale, rng)
                # Adapt the proposal scale towards ~40% acceptance
                if diag > 0.5:
                    scale = min(scale * 1.2, 2.0)
                elif diag < 0.2:
                    scale = max(scale * 0.7, 1e-4)
            self.live_u[worst] = new_u
            live_logl[worst] = new_logl

            it += 1
            # Termination: the evidence still locked in the live points
            # (bounded by max L * remaining X) is a negligible fraction of
            # the accumulated evidence
            log_z_live = np.max(live_logl) + log_x
            done = (np.isfinite(log_z)
                    and log_z_live - log_z < np.log(self.precision))
            if it % 10 == 0 or done:
                diag_name = ('steps' if self.proposal == 'slice'
                             else 'acc')
                print(f'NS iter {it}: logZ = {log_z:.4f}, '
                      f'logZ_live = {log_z_live:.4f}, '
                      f'{diag_name} = {diag:.2f}, scale = {scale:.3f}')
            if it % self.checkpoint_every == 0 or done:
                np.savez(self.checkpoint_path, live_u=self.live_u,
                         live_logl=live_logl, dead_u=dead_u,
                         dead_logl=dead_logl, dead_logw=np.array(dead_logw),
                         dead_neff=np.array(dead_neff),
                         log_x=log_x, log_z=log_z, it=it, scale=scale)
            if done:
                break

        # Bootstrap evidence error over the shrinkage distribution BEFORE
        # folding in the live points: simulate the volume ratios
        # t_i ~ Beta(n_eff_i, 1) (t = U^(1/n_eff)), rebuild logZ per
        # realization including the final live-point block, and take the
        # spread (the standard simulated-volumes estimate; replaces the
        # crude information-based formula)
        log_z_err = self._bootstrap_logz_err(
            np.asarray(dead_logl), np.asarray(dead_neff),
            np.sort(live_logl), rng)

        # Add the remaining live points
        n_live_left = self.num_live
        for idx in np.argsort(live_logl):
            logw = log_x - np.log(n_live_left)
            dead_logw.append(logw + live_logl[idx])
            log_z = np.logaddexp(log_z, logw + live_logl[idx])
        dead_u = np.vstack([dead_u, self.live_u[np.argsort(live_logl)]])
        dead_logl = np.concatenate([dead_logl,
                                    np.sort(live_logl)])

        dead_logw = np.array(dead_logw)
        weights = np.exp(dead_logw - np.max(dead_logw))
        weights /= weights.sum()

        samples = self.prior_transform(dead_u)
        self.write_chain(samples, weights, dead_logl)

        stats_path = Path(self.path) / (self.name + '.stats')
        with open(stats_path, 'w') as f:
            f.write(f'logZ = {log_z} +/- {log_z_err}\n')
            f.write(f'num_iterations = {it}\n')
            f.write(f'num_like_evals = '
                    f'{getattr(self, "_n_evals", 0)}\n')
        print(f'log(Z) = {log_z} +/- {log_z_err}')

        return {
            'samples': samples, 'weights': weights, 'loglikes': dead_logl,
            'logz': log_z, 'logz_err': log_z_err,
        }
