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

from .factored import FactoredXi, stack_coefficients
from .ops.fftlog import FFTLogP2Xi
from .ops.spline import notaknot_second_derivative_matrix
from .ops.spline_combine import KnotGrid, spline_legendre_combine
from .power_spectrum import FactoredPk
from .utils import not_ported, to_tensor

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


def legendre(ell, x):
    """P_ell(x) by Horner's rule on the monomial coefficients."""
    coeffs = LEGENDRE_COEFFS[ell]
    out = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        out = out * x + c
    return out


class PktoXi:
    """Transform plan for one tracer pair on fixed (k, mu_k) grids."""

    def __init__(self, k_grid, muk_grid, muk_weights, config, device):
        self.device = torch.device(device)
        self.k_grid = np.asarray(k_grid, dtype=np.float64)
        self.muk_grid = np.asarray(muk_grid)
        self.muk_weights = np.asarray(muk_weights, dtype=np.float64)

        self.ell_max = config.getint('ell_max', 6)
        if config.getboolean('old_fftlog', False):
            raise not_ported('old_fftlog', 10)
        if config.getboolean('fht_extrap', False):
            raise not_ported('fht_extrap', 10)
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

        fftlogs = [FFTLogP2Xi(self.k_grid, ell, lowring=lowring)
                   for ell in self.ell_vals]
        logr = np.log(fftlogs[0].r_grid)
        ops = np.stack([f.operator() for f in fftlogs])
        s_mat = notaknot_second_derivative_matrix(logr)
        # pk_ell -> spline second derivatives, fused into one operator
        # (the JAX package's np.einsum('ij,ljk->lik', ...) as one BLAS
        # product: equal to round-off, and seconds faster at n_k = 814)
        sd_ops = np.matmul(s_mat, ops)
        self.set_constants(legendre_proj=legendre_proj, fft_ops=ops,
                           fft_sd_ops=sd_ops, logr_knots=logr)

    @classmethod
    def init_from_Pk(cls, pk, config):
        return cls(pk.k_grid, pk.muk_grid, pk.muk_weights, config,
                   device=pk.device)

    def set_constants(self, legendre_proj, fft_ops, fft_sd_ops, logr_knots):
        """Install the host operators (numpy) as device tensors."""
        self.legendre_proj = to_tensor(legendre_proj, self.device)
        self.fft_ops = to_tensor(fft_ops, self.device)
        self.fft_sd_ops = to_tensor(fft_sd_ops, self.device)
        self.logr_knots = np.asarray(logr_knots, dtype=np.float64)
        self.knot_grid = KnotGrid.build(self.logr_knots, self.device)

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

    def compute(self, r_grid, mu_grid, pk, use_kernel=True,
                coords_param_free=False):
        """Transform to xi on the rescaled (r, mu) grids; returns
        (xi, oob_flag) (vega_tpu/pktoxi.py:271-363).

        pk : (n_muk, n_k), (B, n_muk, n_k) or a FactoredPk
        r_grid, mu_grid : (M,) or (B, M)
        Returns xi of shape (B', M), B' the batch of pk and the grids
        (1 when neither is batched), and oob of shape (B',); for a
        FactoredPk with coords_param_free, a FactoredXi whose basis is
        (T, M), or (B', T, M) for batched grids or bases.
        """
        mask = r_grid != 0
        log_r = torch.log(torch.where(mask, r_grid, 1.0))
        legendre_mu = torch.stack([legendre(ell, mu_grid)
                                   for ell in self.ell_vals], dim=-2)
        if isinstance(pk, FactoredPk):
            knots_t, mknots_t = self.factored_knots(pk)
            if coords_param_free:
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
            # FFTLog and spline solve: one f64 GEMM per multipole
            xi_knots = torch.einsum('lij,blj->bli', self.fft_ops, pk_ells)
            m_knots = torch.einsum('lij,blj->bli', self.fft_sd_ops, pk_ells)

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
