"""vega_tpu_torch — the PyTorch / CUDA port of vega_tpu.

A second package beside the JAX reference `vega_tpu/`. It imports torch
and never JAX (nor vega_tpu, whose import pulls JAX in). Every tensor is
created with an explicit device, in the interface's dtype: float64 (the
parity mode) or float32 (vega_tpu's f32 throughput mode, VEGA_TPU_X64=0);
host arrays stay float64 and are cast once. The spline + Legendre
combine, the one Pallas kernel of the JAX package, is a hand-written CUDA
kernel in both dtypes (`csrc/spline_legendre_combine.cu`, built with nvcc
at first use).

The entry point is :class:`vega_tpu_torch.vega_interface.VegaInterface`;
the package exports vega_tpu's eight names lazily (vega_tpu/__init__.py,
`_EXPORTS`), so importing it stays light.
"""

__version__ = '0.1.0'

_EXPORTS = {
    'VegaInterface': 'vega_tpu_torch.vega_interface',
    'BuildConfig': 'vega_tpu_torch.build_config',
    'FitResults': 'vega_tpu_torch.postprocess.fit_results',
    'VegaPlots': 'vega_tpu_torch.plots.plot',
    'Wedge': 'vega_tpu_torch.plots.wedges',
    'Shell': 'vega_tpu_torch.plots.shell',
    'RtWedge': 'vega_tpu_torch.plots.rt_wedges',
    'run_vega': 'vega_tpu_torch.scripts.run_vega',
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
