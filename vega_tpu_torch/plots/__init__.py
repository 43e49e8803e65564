"""Plots of the data and models: host numpy and matplotlib, copies of
vega_tpu/plots (tests/test_torch_plots.py holds them to it)."""
