"""Factored linear model for batched evaluation.

Counterpart of vega_tpu/factored.py. When the sampled parameters enter
the model only through scalar coefficients, the correlation function is

    xi(theta) = sum_t  c_t(theta) * v_t

with parameter-independent basis rows v_t. `FactoredXi` carries
(coeffs, V) through the xi-space pipeline, so every linear operator
downstream of the Hankel transform (z-evolution, growth, distortion,
mask) acts on the basis rows once, and the chi^2 becomes a quadratic form
in the coefficients.

Classification is by NAME. vega_tpu decides that a factor is static when
none of the parameters it read is a jax tracer (`has_tracer`,
`grid_trace`); torch has no tracers, so the caller states which names
are sampled and which of those are grid parameters (`Sampling`), and a
factor counts as parameter-dependent when it read a sampled name that is
not a grid name (`RecordingParams.traced`).

V may carry leading batch axes: the grid-collapse sweep evaluates a
chunk of nodes at once, and the basis rows of a rescaled component are
then (nodes, T, n).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Sampling:
    """The sampled parameter names of an evaluation and, among them, the
    grid parameters whose dependence lives in the basis rows."""
    sampled: frozenset
    grid: frozenset = frozenset()

    def traced(self, name):
        return name in self.sampled and name not in self.grid


class RecordingParams:
    """Read-only params view recording every accessed key, so a factor
    can be classified without hard-coding its parameter list
    (vega_tpu/factored.py:84-110). With `sampling` None nothing counts
    as traced."""

    def __init__(self, params, sampling=None):
        self._params = params
        self._sampling = sampling
        self.accessed = []

    def __getitem__(self, key):
        val = self._params[key]
        self.accessed.append(key)
        return val

    def get(self, key, default=None):
        val = self._params.get(key, default)
        self.accessed.append(key)
        return val

    def __contains__(self, key):
        return key in self._params

    def traced(self):
        return self._sampling is not None and any(
            self._sampling.traced(key) for key in self.accessed)


def _broadcast_cat(a, b):
    """Concatenate two (..., T_i, n) stacks along the term axis,
    broadcasting their leading axes."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return torch.cat([a.expand(batch + a.shape[-2:]),
                      b.expand(batch + b.shape[-2:])], dim=-2)


class FactoredXi:
    """xi = coeffs @ V: scalar coefficients (floats or (B,) tensors) and a
    (..., T, n) basis stack that does not depend on sampled parameters."""

    __slots__ = ('coeffs', 'V')

    def __init__(self, coeffs, V):
        self.coeffs = list(coeffs)
        self.V = V
        if V.dim() < 2 or V.shape[-2] != len(self.coeffs):
            raise ValueError(f'{len(self.coeffs)} coefficients for a basis '
                             f'of shape {tuple(V.shape)}')

    @property
    def n_terms(self):
        return len(self.coeffs)

    def coeff_vector(self):
        """(T,) when every coefficient is a scalar, else (B, T)."""
        return stack_coefficients(self.coeffs, self.V)

    def dense(self):
        return torch.einsum('...t,...tn->...n', self.coeff_vector(), self.V)

    # ----- linear operations (all return new FactoredXi) -----
    def scale(self, scalar):
        return FactoredXi([scalar * c for c in self.coeffs], self.V)

    def mul_vec(self, vec):
        """Elementwise multiply by a parameter-independent vector."""
        return FactoredXi(self.coeffs, self.V * vec[..., None, :])

    def add_vec(self, vec, coeff=1.0):
        """Add coeff * vec as a new term (vec parameter-independent)."""
        return FactoredXi(self.coeffs + [coeff],
                          _broadcast_cat(self.V, vec[..., None, :]))

    def add_terms(self, terms):
        """Add [(coeff, vec)] pairs as new terms."""
        if not terms:
            return self
        rows = torch.stack(torch.broadcast_tensors(*[v for _, v in terms]),
                           dim=-2)
        return FactoredXi(self.coeffs + [c for c, _ in terms],
                          _broadcast_cat(self.V, rows))

    def __add__(self, other):
        if isinstance(other, FactoredXi):
            return FactoredXi(self.coeffs + other.coeffs,
                              _broadcast_cat(self.V, other.V))
        return NotImplemented

    def matmul(self, mat):
        """xi -> M @ xi, pushed onto every basis row."""
        return FactoredXi(self.coeffs, self.V @ mat.T)

    def mask(self, idx):
        """Restrict to masked bins: xi -> xi[idx]."""
        return FactoredXi(self.coeffs, self.V[..., idx])


def stack_coefficients(coeffs, like):
    """Coefficients (floats, 0-d or (B,) tensors) as one f64 tensor on the
    device of `like`: (T,) when all are scalars, else (B, T). A float
    becomes a tensor by a fill on the device, not a copy from the host:
    the samplers' device loops run this inside a CUDA graph."""
    tensors = [c.to(dtype=like.dtype, device=like.device)
               if isinstance(c, torch.Tensor)
               else torch.full((), float(c), dtype=like.dtype,
                               device=like.device)
               for c in coeffs]
    return torch.stack(torch.broadcast_tensors(*tensors), dim=-1)


def densify(xi):
    """Dense view of a possibly factored xi."""
    return xi.dense() if isinstance(xi, FactoredXi) else xi
