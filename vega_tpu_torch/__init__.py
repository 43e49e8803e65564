"""vega_tpu_torch — the PyTorch / CUDA port of vega_tpu.

A second package beside the JAX reference `vega_tpu/`. It imports torch
and never JAX (nor vega_tpu, whose import pulls JAX in). Every tensor is
created f64 with an explicit device; the spline + Legendre combine, the
one Pallas kernel of the JAX package, is a hand-written CUDA kernel
(`csrc/spline_legendre_combine.cu`, built with nvcc at first use).

The entry point is :class:`vega_tpu_torch.vega_interface.VegaInterface`.
"""

__version__ = '0.1.0'
