"""P(k, mu_k) -> xi(r, mu) transform.

Counterpart of vega_tpu/pktoxi.py: the operators are built on the host
at init exactly as there (:141-182), and the dense branch (:326-363)
runs on the device as

  1. Legendre projection:   pk_ell = P_proj @ pk          (B, n_ell, n_k)
  2. FFTLog + spline solve: xi_knots = L_ell @ pk_ell     (f64 GEMMs)
                            m_knots  = SL_ell @ pk_ell
  3. spline evaluation at log(rescaled r), times P_ell(mu), summed over
     ell: the CUDA kernel of ops/spline_combine.py, differentiable twice
     (the fit's gradients and Hessians go through its autograd
     Functions; the grid sweep's grouped call runs under no_grad).

The r = 0 mask and the out-of-range flag are computed here, outside the
kernel (vega_tpu/pktoxi.py:334-336,353-355).

With old_fftlog the operators of step 2 are the legacy Hamilton-2000
ones (`hamilton_operators`, vega_tpu/pktoxi.py:68-110) on their own knot
grid, log r - dr/2 with the last knot's row zero, and their own spline
operators; step 3 is the same kernel on that grid.

With fht_extrap (mcfit's extrap=True) the operators act on the k grid
continued into mcfit's padding and each multipole is continued as a
power law before step 2 (`extrap_operators`, `extrap_pad`), on that
transform's own knot grid. With single_multipole step 3 combines that
multipole's table alone with a weight of 1. The relativistic and
standard-asymmetry terms of the cross (`pk_to_xi_relativistic`,
`pk_to_xi_asymmetry`, vega_tpu/pktoxi.py:367-418) transform the raw
linear spectrum with the legacy operators at ell = (1, 3) and (0, 2)
and run step 3 as one combine of two tables on the legacy knot grid,
their amplitudes folded into the tables.

A FactoredPk (vega_tpu/pktoxi.py:295-324) takes steps 1-2 once for its T
basis grids, whatever the coordinates: (T, n_muk, n_k) -> (T, L, n_k)
knot tables, kept on the FactoredPk. When the rescaled coordinates do
not depend on a sampled name (`coords_param_free`), step 3 runs on the
T tables and the result stays factored (FactoredXi); the grid-collapse
sweep passes a chunk of nodes' coordinates at once, and the kernel reads
each node's coordinate row for that node's T rows (row groups of T).
Otherwise the coefficients are contracted into the knot tables and the
dense combine follows.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy import fft as npfft
from scipy.special import loggamma

from .factored import FactoredXi, stack_coefficients
from .ops.fftlog import FFTLogP2Xi, default_pad_size
from .ops.spline import notaknot_second_derivative_matrix, spline_eval
from .ops.spline_combine import KnotGrid, spline_legendre_combine
from .power_spectrum import FactoredPk
from .utils import col, to_tensor

# scipy.special.legendre(ell) monomial coefficients (poly1d order,
# highest power first); exact binary fractions, so Horner evaluation
# reproduces vega_tpu/pktoxi.py:31-39,58-65 bit for bit.
LEGENDRE_COEFFS = {
    0: [1.0],
    1: [1.0, 0.0],
    2: [1.5, 0.0, -0.5],
    3: [2.5, 0.0, -1.5, 0.0],
    4: [4.375, 0.0, -3.75, 0.0, 0.375],
    5: [7.875, 0.0, -8.75, 0.0, 1.875, 0.0],
    6: [14.4375, 0.0, -19.6875, 0.0, 6.5625, 0.0, -0.3125],
}


def hamilton_operators(k, ell_vals, n_exp, project_scale):
    """Dense operators of the legacy Hamilton-2000 transform (the
    conventions of the reference's Pk2Mp; vega_tpu/pktoxi.py:68-110):
    (ops (n_ell, n_r, n_k), logr_knots (n_r,)), ops[i] mapping the input
    spectrum (a multipole if project_scale, else the raw 1D pk) to xi at
    the shifted knots log(r) - dr/2, the last knot's row zero."""
    k = np.asarray(k, dtype=np.float64)
    k0 = k[0]
    log_span = np.log(k.max() / k0)
    n = len(k)
    emm = n * npfft.fftfreq(n)
    r = 1.0 * np.exp(-emm * log_span / n)
    dr = abs(np.log(r[1] / r[0]))
    order = np.argsort(r)
    r_sorted = r[order]

    q = 2.0 - n_exp - 0.5
    x = q + 2j * np.pi * emm / log_span

    ops = []
    for ell in ell_vals:
        mu = ell + 0.5
        lg1 = loggamma((mu + 1 + x) / 2)
        lg2 = loggamma((mu + 1 - x) / 2)
        um = (k0 * 1.0) ** (-2j * np.pi * emm / log_span) \
            * 2 ** x * np.exp(lg1 - lg2)
        um[0] = um[0].real
        # input -> fft -> * um -> ifft -> sort -> / r^(3 - n)
        weight = k ** n_exp * np.sqrt(np.pi / 2)
        if project_scale:
            # the standard path folds (-1)^(ell//2) / (2 pi^2) into the
            # projected multipole (the reference's pktoxi.py:260)
            weight = weight * ((-1.0) ** (ell // 2) / (2 * np.pi ** 2))
        basis = np.eye(n) * weight[None, :]
        an = npfft.fft(basis, axis=1) * um[None, :]
        xi_rows = npfft.ifft(an, axis=1)[:, order].real
        xi_rows /= r_sorted[None, :] ** (3 - n_exp)
        xi_rows[:, -1] = 0.0
        ops.append(np.ascontiguousarray(xi_rows.T))
    return np.stack(ops), np.log(r_sorted) - dr / 2


# (k bytes, ell_vals, n_exp, project_scale) -> (ops, logr, sd_ops), host
# f64, as vega_tpu's _LEGACY_OPERATOR_CACHE (vega_tpu/pktoxi.py:384-392)
_HOST_LEGACY = {}


def host_legacy_operators(k, ell_vals, n_exp, project_scale):
    """(ops, logr_knots, sd_ops) of hamilton_operators, sd_ops the
    not-a-knot second derivatives fused in as one BLAS product; built
    once per key."""
    k = np.asarray(k, dtype=np.float64)
    key = (k.tobytes(), tuple(ell_vals), n_exp, project_scale)
    if key not in _HOST_LEGACY:
        ops, logr = hamilton_operators(k, ell_vals, n_exp, project_scale)
        _HOST_LEGACY[key] = (
            ops, logr,
            np.matmul(notaknot_second_derivative_matrix(logr), ops))
    return _HOST_LEGACY[key]


def legacy_multipoles(logr_knots, ops, sd_ops, spectra, log_r, knots=None):
    """(n_ell, M): each multipole's plain spline of the tables ops[i] @
    spectra[i] at log_r (vega_tpu/pktoxi.py:376-382)."""
    vals, _ = spline_eval(
        logr_knots, torch.einsum('lij,lj->li', ops, spectra)[:, None, :],
        torch.einsum('lij,lj->li', sd_ops, spectra)[:, None, :],
        log_r[None, :], knots=knots)
    return vals[:, 0, :]


def extrap_operators(k, ell_vals, lowring):
    """The transform of fht_extrap (mcfit's extrap=True;
    vega_tpu/pktoxi.py:205-236): each multipole's FFTLog operator on the
    k grid continued geometrically into mcfit's padding (n_fft, the same
    centred split as the zero-padded transform), its rows sliced back to
    the r grid of the unpadded one. Returns (ops (n_ell, n, n_fft),
    logr_knots (n,), (pad_l, pad_r))."""
    k = np.asarray(k, dtype=np.float64)
    n = len(k)
    n_fft = default_pad_size(n)
    delta = np.log(k[-1] / k[0]) / (n - 1)
    pad_l = (n_fft - n) // 2
    pad_r = n_fft - n - pad_l
    k_full = np.concatenate([
        k[0] * np.exp(-delta * np.arange(pad_l, 0, -1)),
        k,
        k[-1] * np.exp(delta * np.arange(1, pad_r + 1)),
    ])
    ops = []
    logr = None
    for ell in ell_vals:
        tr = FFTLogP2Xi(k_full, ell, lowring=lowring, pad_to=0)
        # r_i = e^lnxy / k[n - 1 - i] sits at extended index pad_r + i
        ops.append(tr.operator()[pad_r:pad_r + n, :])
        if logr is None:
            logr = np.log(tr.r_grid[pad_r:pad_r + n])
    return np.stack(ops), logr, (pad_l, pad_r)


def extrap_pad(pk_ells, pad_l, pad_r):
    """Power-law continuation of each multipole (..., n) into the
    padding, (..., pad_l + n + pad_r) (vega_tpu/pktoxi.py:238-262): f_edge
    rho^step with rho = |f_edge / f_inward| outward from each end; an end
    that is zero or changes sign pads with zeros."""
    def continuation(f_edge, f_inward, steps):
        safe = f_edge * f_inward > 0
        rho = torch.where(safe, torch.abs(f_edge / torch.where(
            f_inward == 0, 1.0, f_inward)), 1.0)
        vals = f_edge[..., None] * rho[..., None] ** steps
        return torch.where(safe[..., None], vals, 0.0)

    steps = torch.arange(pad_l + pad_r + 1, dtype=pk_ells.dtype,
                         device=pk_ells.device)
    left = continuation(pk_ells[..., 0], pk_ells[..., 1],
                        steps[1:pad_l + 1].flip(0))
    right = continuation(pk_ells[..., -1], pk_ells[..., -2],
                         steps[1:pad_r + 1])
    return torch.cat([left, pk_ells, right], dim=-1)


def legendre(ell, x):
    """P_ell(x) by Horner's rule on the monomial coefficients."""
    coeffs = LEGENDRE_COEFFS[ell]
    out = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        out = out * x + c
    return out


class PktoXi:
    """Transform plan for one tracer pair on fixed (k, mu_k) grids."""

    def __init__(self, k_grid, muk_grid, muk_weights, config, device,
                 dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        self.k_grid = np.asarray(k_grid, dtype=np.float64)
        self.muk_grid = np.asarray(muk_grid)
        self.muk_weights = np.asarray(muk_weights, dtype=np.float64)

        self.ell_max = config.getint('ell_max', 6)
        self.old_fftlog = config.getboolean('old_fftlog', False)
        # mcfit's extrap=True: operators on the extended k grid and a
        # power-law continuation of each multipole (old_fftlog wins)
        extrap = (config.getboolean('fht_extrap', False)
                  and not self.old_fftlog)
        lowring = config.getboolean('fht_lowring', True)
        self.ell_vals = tuple(int(e) for e in
                              np.arange(0, self.ell_max + 1, 2))

        # Legendre projection with the quadrature and (2l+1) weights
        muk = self.muk_grid.ravel()
        legendre_proj = np.stack([
            np.polyval(LEGENDRE_COEFFS[ell], muk)
            * self.muk_weights * (2 * ell + 1)
            for ell in self.ell_vals
        ])                                                  # (n_ell, n_muk)

        self._extrap_geom = None
        if self.old_fftlog:
            # the operators pk_to_xi reads too
            ops, logr, sd_ops = host_legacy_operators(
                self.k_grid, self.ell_vals, n_exp=2, project_scale=True)
        else:
            if extrap:
                ops, logr, self._extrap_geom = extrap_operators(
                    self.k_grid, self.ell_vals, lowring)
            else:
                fftlogs = [FFTLogP2Xi(self.k_grid, ell, lowring=lowring)
                           for ell in self.ell_vals]
                logr = np.log(fftlogs[0].r_grid)
                ops = np.stack([f.operator() for f in fftlogs])
            # pk_ell -> spline second derivatives, fused into one operator
            # (the JAX package's np.einsum('ij,ljk->lik', ...) as one BLAS
            # product: equal to round-off, and seconds faster at n_k = 814)
            sd_ops = np.matmul(notaknot_second_derivative_matrix(logr), ops)
        self.set_constants(legendre_proj=legendre_proj, fft_ops=ops,
                           fft_sd_ops=sd_ops, logr_knots=logr)
        # the legacy operators of the relativistic and asymmetry terms,
        # built at their first use (vega_tpu/pktoxi.py:399-409)
        self._legacy = {}

    @classmethod
    def init_from_Pk(cls, pk, config):
        return cls(pk.k_grid, pk.muk_grid, pk.muk_weights, config,
                   device=pk.device, dtype=pk.dtype)

    def set_constants(self, legendre_proj, fft_ops, fft_sd_ops, logr_knots):
        """Install the host operators (numpy, f64) as device tensors in
        the model's dtype."""
        self.legendre_proj = to_tensor(legendre_proj, self.device,
                                       self.dtype)
        self.fft_ops = to_tensor(fft_ops, self.device, self.dtype)
        self.fft_sd_ops = to_tensor(fft_sd_ops, self.device, self.dtype)
        self.logr_knots = np.asarray(logr_knots, dtype=np.float64)
        self.knot_grid = KnotGrid.build(self.logr_knots, self.device,
                                        self.dtype)

    def factored_knots(self, pk):
        """Knot tables (xi, m) of a FactoredPk's basis grids, each
        (T, ..., L, N), computed once and kept on `pk`
        (vega_tpu/pktoxi.py:296-302)."""
        if pk.knots is None:
            basis = torch.stack(torch.broadcast_tensors(*pk.bases))
            pk_ells = torch.matmul(self.legendre_proj, basis)
            pk.knots = (
                torch.einsum('lij,...lj->...li', self.fft_ops, pk_ells),
                torch.einsum('lij,...lj->...li', self.fft_sd_ops, pk_ells))
        return pk.knots

    def compute_pk_ells(self, pk):
        """P(k, mu_k) -> its multipoles (..., n_ell, n_k): the Legendre
        projection, a FactoredPk densified first (vega_tpu/pktoxi.py:
        264-269). One GEMM, no combine."""
        if isinstance(pk, FactoredPk):
            pk = pk.dense()
        return torch.matmul(self.legendre_proj, pk)

    def compute(self, r_grid, mu_grid, pk, use_kernel=True,
                coords_param_free=False, single_ell=-1):
        """Transform to xi on the rescaled (r, mu) grids; returns
        (xi, oob_flag) (vega_tpu/pktoxi.py:271-363). With `single_ell` >= 0
        (single_multipole) xi is that multipole alone, without its
        Legendre weight: the combine of its one table with a weight of 1,
        and a FactoredPk is contracted first (vega_tpu/pktoxi.py:308,
        338-343). fht_extrap densifies a FactoredPk (its continuation is
        not linear in P) and continues each multipole into the padding
        before the transform.

        pk : (n_muk, n_k), (B, n_muk, n_k) or a FactoredPk
        r_grid, mu_grid : (M,) or (B, M)
        Returns xi of shape (B', M), B' the batch of pk and the grids
        (1 when neither is batched), and oob of shape (B',); for a
        FactoredPk with coords_param_free, a FactoredXi whose basis is
        (T, M), or (B', T, M) for batched grids or bases.
        """
        mask = r_grid != 0
        log_r = torch.log(torch.where(mask, r_grid, 1.0))
        if isinstance(pk, FactoredPk) and self._extrap_geom is not None:
            pk = pk.dense()
        if single_ell < 0:
            legendre_mu = torch.stack([legendre(ell, mu_grid)
                                       for ell in self.ell_vals], dim=-2)
        else:
            li = list(self.ell_vals).index(int(single_ell))
            legendre_mu = torch.ones((1, 1, log_r.shape[-1]),
                                     dtype=log_r.dtype, device=log_r.device)
        if isinstance(pk, FactoredPk):
            knots_t, mknots_t = self.factored_knots(pk)
            if coords_param_free and single_ell < 0:
                return self._factored_rows(pk, knots_t, mknots_t, log_r,
                                           legendre_mu, mask, use_kernel)
            theta = stack_coefficients(pk.coeffs, knots_t).reshape(
                -1, knots_t.shape[0])                          # (B, T)
            xi_knots = torch.einsum('bt,tli->bli', theta, knots_t)
            m_knots = torch.einsum('bt,tli->bli', theta, mknots_t)
        else:
            pk_ells = torch.matmul(self.legendre_proj, pk)   # (.., L, n_k)
            if pk_ells.dim() == 2:
                pk_ells = pk_ells[None]
            if self._extrap_geom is not None:
                pk_ells = extrap_pad(pk_ells, *self._extrap_geom)
            # FFTLog and spline solve: one f64 GEMM per multipole
            xi_knots = torch.einsum('lij,blj->bli', self.fft_ops, pk_ells)
            m_knots = torch.einsum('lij,blj->bli', self.fft_sd_ops, pk_ells)

        if single_ell >= 0:
            xi_knots = xi_knots[:, li:li + 1]
            m_knots = m_knots[:, li:li + 1]
        n_b = max(xi_knots.shape[0],
                  log_r.shape[0] if log_r.dim() == 2 else 1)
        n_q = log_r.shape[-1]
        xi = spline_legendre_combine(
            self.knot_grid,
            xi_knots.expand(n_b, -1, -1).contiguous(),
            m_knots.expand(n_b, -1, -1).contiguous(),
            log_r.expand(n_b, n_q), legendre_mu.expand(n_b, -1, n_q),
            use_kernel=use_kernel)
        xi = torch.where(mask, xi, 0.0)
        return xi, self._oob(log_r, mask).expand(n_b)

    # ------------------------------------------------------------------
    # The relativistic and standard-asymmetry terms of the cross
    # (vega_tpu/pktoxi.py:367-418): legacy Hamilton operators on the raw
    # linear spectrum, each term one combine of two tables on the legacy
    # knot grid, the amplitudes folded into the tables
    # ------------------------------------------------------------------
    def legacy_operators(self, ell_vals, n_exp, project_scale=False):
        """(knot grid, ops, sd_ops) of the legacy transform at `ell_vals`
        with k^n_exp, of the raw spectrum or, with project_scale, of its
        multipoles; built once (vega_tpu/pktoxi.py:384-409)."""
        key = (ell_vals, n_exp, project_scale)
        if key not in self._legacy:
            ops, logr, sd_ops = host_legacy_operators(
                self.k_grid, ell_vals, n_exp, project_scale)
            self._legacy[key] = (
                KnotGrid.build(logr, self.device, self.dtype),
                to_tensor(ops, self.device, self.dtype),
                to_tensor(sd_ops, self.device, self.dtype))
        return self._legacy[key]

    def _legacy_combine(self, pk, ell_vals, n_exp, rows, r_grid, leg,
                        use_kernel):
        """sum_j S_j(log r) leg[j] with the tables y_j = sum c K_i over the
        (c, i) of rows[j], K = ops @ pk the legacy multipoles of the (n_k,)
        spectrum, c a float or a (B,) tensor; leg (2, M) or (B, 2, M).
        r = 0 reads log 1, unmasked, as vega_tpu's `_legacy_eval`
        (:380-386)."""
        grid, ops, sd_ops = self.legacy_operators(ell_vals, n_exp)

        def tables(k):                                   # (B', 2, N)
            out = []
            for row in rows:
                t = None
                for c, i in row:
                    term = col(c, 1) * k[i]
                    t = term if t is None else t + term
                out.append(t.reshape(-1, k.shape[-1]))
            return torch.stack(torch.broadcast_tensors(*out), dim=-2)

        y, m = tables(ops @ pk), tables(sd_ops @ pk)
        log_r = torch.log(torch.where(r_grid != 0, r_grid, 1.0))
        n_b = max(y.shape[0], log_r.shape[0] if log_r.dim() == 2 else 1)
        n_q = log_r.shape[-1]
        return spline_legendre_combine(
            grid, y.expand(n_b, -1, -1).contiguous(),
            m.expand(n_b, -1, -1).contiguous(), log_r.expand(n_b, n_q),
            leg.expand(n_b, -1, n_q), use_kernel=use_kernel)

    def pk_to_xi_relativistic(self, r_grid, mu_grid, pk, params,
                              use_kernel=True):
        """Relativistic dipole and octupole (Bonvin et al. 2014;
        vega_tpu/pktoxi.py:388-395): Arel1 S_1(log r) P_1(mu) + Arel3
        S_3(log r) P_3(mu), S_l the legacy l-transform of pk with k^1."""
        leg = torch.stack([legendre(1, mu_grid), legendre(3, mu_grid)],
                          dim=-2)
        return self._legacy_combine(
            pk, (1, 3), 1, ([(params['Arel1'], 0)], [(params['Arel3'], 1)]),
            r_grid, leg, use_kernel)

    def pk_to_xi_asymmetry(self, r_grid, mu_grid, pk, params,
                           use_kernel=True):
        """Standard asymmetry (Bonvin et al. 2014;
        vega_tpu/pktoxi.py:397-405): (Aasy0 S_0 - Aasy2 S_2) r P_1(mu) +
        Aasy3 S_2 r P_3(mu), S_l the legacy l-transform of pk with k^2."""
        leg = torch.stack([r_grid * legendre(1, mu_grid),
                           r_grid * legendre(3, mu_grid)], dim=-2)
        return self._legacy_combine(
            pk, (0, 2), 2, ([(params['Aasy0'], 0), (-params['Aasy2'], 1)],
                            [(params['Aasy3'], 1)]),
            r_grid, leg, use_kernel)

    # ------------------------------------------------------------------
    # vega_tpu's reference-named views (vega_tpu/pktoxi.py:421-515): the
    # per-multipole interpolators of the transform above and the outdated
    # Hamilton-2000 path, evaluated by the plain spline on the host (f64)
    # as vega_tpu evaluates them, never through the combine kernel
    # ------------------------------------------------------------------
    def compute_xi_ell(self, pk, ell_vals, *cache_pars):
        """{ell: Xi_ell(log r)} of `pk` (n_muk, n_k), each a host function
        of log r that raises utils.VegaBoundsError out of the knot range
        (vega_tpu/pktoxi.py:428-458). The knot tables are this
        transform's, in its dtype; *cache_pars are accepted and ignored,
        as there."""
        del cache_pars
        pk = to_tensor(pk, self.device, self.dtype)
        pk_ells = torch.matmul(self.legendre_proj, pk)
        if self._extrap_geom is not None:
            pk_ells = extrap_pad(pk_ells[None], *self._extrap_geom)[0]
        xi_knots = torch.einsum('lij,lj->li', self.fft_ops, pk_ells)
        m_knots = torch.einsum('lij,lj->li', self.fft_sd_ops, pk_ells)
        xi_knots = xi_knots.detach().cpu().double()
        m_knots = m_knots.detach().cpu().double()
        out = {}
        for i, ell in enumerate(self.ell_vals):
            if ell in ell_vals:
                out[ell] = _HostInterpolator(self.logr_knots, xi_knots[i],
                                             m_knots[i])
        return out

    @staticmethod
    def compute_xi(xi_ell_interp, r_grid, mu_grid):
        """sum_ell Xi_ell(log r) P_ell(mu) on the host, 0 at r = 0
        (vega_tpu/pktoxi.py:460-471)."""
        r_grid = np.asarray(r_grid, dtype=np.float64)
        mu = torch.as_tensor(np.asarray(mu_grid, dtype=np.float64))
        mask = r_grid != 0
        full_xi = np.zeros(len(r_grid))
        for ell, interp in xi_ell_interp.items():
            xi_ell = np.zeros(len(r_grid))
            xi_ell[mask] = interp(np.log(r_grid[mask]))
            full_xi += xi_ell * legendre(ell, mu).numpy()
        return full_xi

    @staticmethod
    def Pk2Mp(ar, k, pk, ell_vals, muk, dmuk, tform=None):
        """The outdated Hamilton-2000 multipole transform
        (vega_tpu/pktoxi.py:473-500): (n_ell, len(ar)) host array indexed
        by ell // 2; tform 'rel' takes k^1 and 'rel' / 'asy' the raw
        spectrum, else each multipole is projected first."""
        ell_vals = tuple(int(e) for e in ell_vals)
        project = tform not in ('rel', 'asy')
        ops, logr, sd_ops = host_legacy_operators(
            k, ell_vals, 1 if tform == 'rel' else 2, project)
        muk = np.asarray(muk)
        if project:
            spectra = np.stack([
                np.sum(dmuk * np.polyval(LEGENDRE_COEFFS[ell], muk) * pk,
                       axis=0) * (2 * ell + 1) for ell in ell_vals])
        else:
            spectra = np.stack([np.asarray(pk, dtype=np.float64)]
                               * len(ell_vals))
        vals = legacy_multipoles(
            logr, torch.as_tensor(ops), torch.as_tensor(sd_ops),
            torch.as_tensor(spectra),
            torch.as_tensor(np.log(np.asarray(ar, dtype=np.float64))))
        xi = np.zeros((len(ell_vals), vals.shape[-1]))
        for i, ell in enumerate(ell_vals):
            xi[ell // 2] = vals[i].numpy()
        return xi

    def pk_to_xi(self, r_grid, mu_grid, pk, multipole=-1):
        """The correlation of `pk` (n_muk, n_k) on (r, mu) by the
        Hamilton-2000 conventions, or its multipole `multipole` alone
        when that is >= 0 (vega_tpu/pktoxi.py:502-516): the projected
        legacy operators, the plain spline in this transform's dtype on
        its device."""
        ell_vals = (self.ell_vals if multipole < 0
                    else (int(multipole),))
        grid, ops, sd_ops = self.legacy_operators(ell_vals, 2,
                                                  project_scale=True)
        muk = self.muk_grid.ravel()
        proj = np.stack([np.polyval(LEGENDRE_COEFFS[ell], muk)
                         * self.muk_weights * (2 * ell + 1)
                         for ell in ell_vals])
        pk_ells = torch.matmul(to_tensor(proj, self.device, self.dtype),
                               to_tensor(pk, self.device, self.dtype))
        r_grid = to_tensor(r_grid, self.device, self.dtype)
        log_r = torch.log(torch.where(r_grid != 0, r_grid, 1.0))
        vals = legacy_multipoles(grid.values, ops, sd_ops, pk_ells, log_r,
                                 knots=grid.tensor)
        if multipole >= 0:
            return vals[0]
        mu_grid = to_tensor(mu_grid, self.device, self.dtype)
        return sum(vals[i] * legendre(ell, mu_grid)
                   for i, ell in enumerate(ell_vals))

    def _oob(self, log_r, mask):
        """(B',) out-of-range flag of (M,) or (B', M) coordinates."""
        knots = self.knot_grid.values
        oob = ((log_r < knots[0]) | (log_r > knots[-1])) & mask
        return oob.reshape(-1, oob.shape[-1]).any(dim=-1)

    def _factored_rows(self, pk, knots_t, mknots_t, log_r, legendre_mu,
                       mask, use_kernel):
        """FactoredXi of the T basis rows at parameter-free coordinates
        (vega_tpu/pktoxi.py:308-320): one combine over n_c * T rows in
        node-major order, n_c the coordinate (or knot-table) batch, each
        group of T rows reading its node's coordinate row."""
        n_t, n_q = knots_t.shape[0], log_r.shape[-1]
        n_ell, n_knots = knots_t.shape[-2:]
        n_c = max(log_r.shape[0] if log_r.dim() == 2 else 1,
                  knots_t.shape[1] if knots_t.dim() == 4 else 1)

        def node_major(tables):       # (T, [n_c,] L, N) -> (n_c * T, L, N)
            if tables.dim() == 4:
                tables = tables.transpose(0, 1)
            return tables.expand(n_c, n_t, n_ell, n_knots).reshape(
                n_c * n_t, n_ell, n_knots).contiguous()

        rows = spline_legendre_combine(
            self.knot_grid, node_major(knots_t), node_major(mknots_t),
            log_r.expand(n_c, n_q), legendre_mu.expand(n_c, n_ell, n_q),
            group=n_t, use_kernel=use_kernel).reshape(n_c, n_t, n_q)
        rows = torch.where(mask[..., None, :], rows, 0.0)
        batched = log_r.dim() == 2 or knots_t.dim() == 4
        return (FactoredXi(pk.coeffs, rows if batched else rows[0]),
                self._oob(log_r, mask).expand(n_c))


class _HostInterpolator:
    """One multipole's Xi_ell(log r) on the host in f64: the cubic spline
    of its knot tables, raising VegaBoundsError out of the knot range
    (vega_tpu/pktoxi.py:446-455)."""

    def __init__(self, logr_knots, xi_knots, m_knots):
        self._logr = logr_knots
        self._xi, self._m = xi_knots, m_knots

    def __call__(self, log_r_query):
        from .utils import VegaBoundsError
        q = torch.as_tensor(np.atleast_1d(np.asarray(log_r_query,
                                                     dtype=np.float64)))
        vals, oob = spline_eval(self._logr, self._xi, self._m, q)
        if bool(oob.any()):
            raise VegaBoundsError('Xi_ell interpolation out of range.')
        return vals.numpy()
