#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (vega_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port end to end at the full width of the synthetic auto+cross
configuration, with no JAX:

1. requires CUDA and prints the card's name and power limit;
2. builds the CUDA kernel from the checkout's sources (nvcc);
3. the dense path: make_synthetic_dataset(cross=True, size='full') with
   the port, then VegaInterface(..., device='cuda') built with
   VEGA_TPU_FACTORED=0: chi^2 at the defaults (< 1e-6), chi2_batch on
   8192 rows of (ap, at, bias_LYA, beta_LYA) drawn as bench.py draws them
   (finite; the kernel launched), the kernel path against use_kernel=False
   (1e-10 relative), the JAX goldens of tests/data/torch_port_goldens.json
   (1e-8 relative), and evals/s;
4. the grid path, bench.py's regime: the same configuration with the
   defaults (32 x 32 Chebyshev nodes over ap, at in [0.75, 1.25]): the
   collapse (device node sweep through the kernel, host payload build;
   both timed), chi2_batch on the 8192 drawn rows (finite, no penalty),
   the JAX grid goldens of tests/data/torch_port_grid_goldens.json
   (|d chi2| <= 2e-4 + 1e-9 |chi2| against the JAX grid chi^2, and within
   the JAX package's own max |grid - dense| + 2e-4 of its dense chi^2),
   evals/s at batch 8192 and 32768 (median of 5 rounds, each fetching the
   result to the host, as bench.py:207-221; each round's host issue time
   beside its total), printed in bench.py's JSON shape, and a
   torch.profiler breakdown of one chi2_batch(8192);
5. the fit, on the same configuration with (ap, at, bias_LYA, beta_LYA)
   sampled from the start of tests/data/torch_port_fit_goldens.json:
   - the grid regime (the defaults): chi2_value_and_gradient and
     chi2_hessian at the goldens' points against the JAX grid goldens,
     and minimize() against the JAX grid fit;
   - the dense regime (VEGA_TPU_FACTORED=0): the same against the JAX
     dense goldens, the same calls with use_kernel=True against
     use_kernel=False (1e-10 relative in gradients, 1e-9 in Hessians),
     and minimize() against the JAX dense fit; it fails unless the dense
     fit launched the transpose kernel and a kernel of order d >= 1;
5b. the f32 throughput mode (phase f32), vega_tpu's VEGA_TPU_X64=0, on
   the fit configuration, against tests/data/torch_port_f32_goldens.json
   (vega_tpu's f32 and f64 on the same files) within vega_tpu's f32
   ladder (tests/test_f32_mode.py:106-109: |d chi2| <= 0.3 and <= 3e-4
   |chi2|; fits within 1e-2 of the JAX errors):
   - dense (VegaInterface built under VEGA_TPU_X64=0): chi2_batch(8192)
     in f32 with only f32 kernels launched, kernel vs plain route and the
     JAX f32 dense chi^2 (the ladder), the f64 interface and vega_tpu's
     f64 (reported), evals/s of f64 and f32 in turns, a profile of
     each;
   - grid (dtype=torch.float32), 32 x 32 nodes: the cold sweep through
     the f32 F_0, chi2_batch against vega_tpu's f64 grid (the ladder)
     and its f32 grid (reported: vega_tpu's f32 host centring loses ~8.5
     chi^2 there, ROADMAP.md section 3), 8192 / 32768 in bench.py's JSON
     shape with f32 in its unit, a profile;
   - minimize() dense and on the payload against the JAX f32 fits; it
     fails unless the dense fit launched the f32 Ft_d and an f32 kernel
     of order d >= 1;
   every f32 launch layout is held against its f32 plain version (1e-5
   of max|ref|) and reported against the f64 kernel on the same inputs,
   and the six edge layouts run in f32 too;
6. the profile scan: batched_chi2_scan over a 40 x 40 (ap, at) grid,
   each of linspace(0.95, 1.05, 40), on the fit configuration with
   bias_LYA and beta_LYA re-minimised at every point on the grid
   payload: cold (with the payload) and warm in one fit chunk, and a
   10 x 10 corner of it warm at the default chunk (8), with wall time,
   Newton iterations, rows valid and peak memory; the default chunk's
   fval against the one chunk's (1e-8: the rows are independent); 16
   points against the JAX
   scan of tests/data/torch_port_mc_goldens.json (|d fval| <= 2e-4 +
   1e-9 |fval|, values within 1e-2 of the JAX errors);
7. Monte-Carlo mock fits (MonteCarloEngine) on the fit configuration
   with [monte carlo] and [mc parameters]: 32 dense mocks of (ap, at,
   bias_LYA, beta_LYA) at the default chunk and in one chunk, 512 in one
   chunk, and 256 mocks of (bias_LYA, beta_LYA) through the nuisance
   collapse without data terms; each with 4 numpy mocks held against the
   JAX fits of the goldens (values 1e-3 of the errors, errors 1e-5
   relative, chi^2 1e-8, valid equal), the dense ones also through the
   plain combine; it fails unless the dense fits launched the transpose
   and a kernel of order d >= 1 at B > 1.

8. the DR16-shaped model (phase dr16), configuration synthetic-dr16-full:
   the same dataset with Rogers HCD, Arinyo small-scale NL and the metals
   SiII(1190), SiII(1193), SiII(1260), SiIII(1207) in every LYA tracer
   (identity metal matrices), and (ap, at, bias_LYA, beta_LYA, bias_hcd,
   beta_hcd, bias_SiII(1260), bias_SiIII(1207)) sampled, against the JAX
   goldens of tests/data/torch_port_dr16_goldens.json:
   - dense regime: chi2_batch(8192) (1e-8 relative; kernel vs plain
     route 1e-10), evals/s, peak memory, and the shares of the metal
     stack and of the power-spectrum grids (HCD, NL, Kaiser) in one call
     (CUDA events around them);
   - grid regime, 32 x 32 nodes: collapse time, T, payload modes,
     chi2_batch at 8192 / 32768 in bench.py's JSON shape (2e-4 + 1e-9
     |chi2| against the JAX grid chi^2), kernels per call and idle share;
   - the fit in each regime against the JAX fit (values 1e-2 / 1e-3 of
     the JAX errors, derivatives 1e-6 / 1e-8);
   it fails unless the metal stack launched F_0 on the dense and the
   grid path and Ft_d in the dense fit.
8b. the reference's own model terms (phase uv), configuration
   synthetic-dr16-uv-full (testing.make_dr16_uv_dataset): the DR16-shaped
   model with UV fluctuations and shotnoise in both correlations and the
   relativistic, asymmetry and Croom terms on the cross, twelve names
   sampled, against tests/data/torch_port_uv_goldens.json:
   - dense regime: chi2_batch(8192) (finite; kernel vs plain route
     1e-10), the JAX dense chi^2 at 8 points (1e-8), evals/s;
   - vega_tpu's route: the auto from the 32 x 32 payload with the UV
     terms in its basis, the cross dense; the payload's correlations and
     terms against the JAX payload's, chi^2 within 2e-4 + 1e-9 |chi2|,
     evals/s;
   - value and gradient at 2 points on both (1e-6 / 1e-8) and
     minimize() on the dense path against the JAX dense fit;
   - one dense chi^2 of each variant (HeII, the split bias evolution with
     OMEGAM, single_multipole = 0, fht_extrap on the auto without
     metals) against its golden (1e-8);
   - every launch layout held as below, and the edge layouts on the
     legacy knot grid with two tables and on fht_extrap's grid;
   it fails unless the relativistic and asymmetry terms launched F_0 of
   two tables, the dense fit Ft_d of two tables, and single_multipole
   F_0 of one.
9. the DESI DR1 baseline model (phase desi), configuration
   synthetic-desi-full: the same dataset with the DR16 model's HCD and
   NL, the QSO radiation on the cross, the DESI instrumental systematics
   on the auto, the metals SiII(1190), SiII(1193), SiIII(1207),
   SiII(1260), CIV(eff) in every LYA tracer with new-metals matrices
   computed on the host from seeded stacked-delta weights (rebinned by
   3), DESI's 17 sampled names and Gaussian priors, and the joint
   covariance, against the JAX goldens of
   tests/data/torch_port_desi_goldens.json:
   - dense regime under the joint covariance: chi^2 at the defaults (the
     priors'), chi2_batch(8192) (1e-8 relative; kernel vs plain route
     1e-10), evals/s, peak memory, the host build time of the matrices,
     and the shares of the metal matrices' GEMMs, the metal stack's
     combine, the power-spectrum grids and the joint quadratic form in
     one call (CUDA events around them);
   - grid regime under per-correlation covariances (the same files
     without the global-cov-file line), 14 names, 32 x 32 nodes:
     collapse time, T, payload modes, chi2_batch at 8192 / 32768 in
     bench.py's JSON shape (2e-4 + 1e-9 |chi2| against the JAX grid
     chi^2), kernels per call and idle share;
   - derivatives at two points (1e-8), minimize() against the JAX fit
     (values 1e-2 / errors 1e-3 of the JAX errors), one seeded global
     mock through initialize_monte_carlo (1e-8 of the JAX mock; its
     initial fit is the fit before) and a fit on it against the JAX one;
   it fails unless the metal stack launched F_0 on the dense and the
   grid path and Ft_d in the dense fit.
9b. small-scale marginalization (phase marg), configuration
   synthetic-desi-marg-full: the DESI DR1 baseline model of phase desi on
   the same full dataset with a distortion matrix (the cross's 5,000 x
   5,000), noise of 1 sigma (seed 0), per-correlation covariances, and in
   both [model]s BuildConfig's
   marginalization (testing.MARG_MODEL: all-rmin, prior 10,
   fit-marginalized-scales, marginalize-match-data-bins), DESI_MARG_SAMPLE's
   five names, against tests/data/torch_port_marg_goldens.json:
   - the templates in the covariance: templates, retained modes and
     effective sizes per correlation (equal to the JAX package's); the
     dense regime as desi_mock's (chi2_batch(8192), kernel vs plain route,
     the JAX chi^2 and value and gradient 1e-8, evals/s, device shares);
     the template coefficients at a point (1e-8 of max|ref|); vega_tpu's
     grid route (32 x 32 nodes over (ap, at), the linear names in the
     coefficient program) on the updated inverse covariance, cold build,
     T against the JAX payload's, chi^2 within 2e-4 + 1e-9 |chi2|,
     evals/s; minimize() dense against the JAX fit (1e-3 of the JAX
     errors) and bestfit_marg_coeff at the JAX best fit (1e-8);
   - a second interface on the same files with marginalize-in-fit = True
     (no collapse, every call dense): chi2_batch(8192), evals/s, the JAX
     chi^2 and value and gradient (1e-8), the coefficients (1e-8), a fit
     and its bestfit_marg_coeff as above;
   it fails unless both fits launched Ft_d.
10. eBOSS DR16's 13-name combined fit (phase table6), configuration
   synthetic-dr16-table6-full: the DR16-shaped dataset with
   testing.TABLE6_SAMPLE sampled (ap, at, drp_QSO,
   sigma_velo_disp_lorentz_QSO on the grid, nine linear names), against
   tests/data/torch_port_table6_goldens.json and
   benchmarks/table6_accuracy.json, with the payload's disk cache in a
   directory of its own under the run's temporary directory (every
   earlier phase runs with VEGA_TPU_GRID_CACHE=0 and the cache directory
   there too):
   - cold build: the 4-dimension combination payload swept into the empty
     cache (spec 32 x 32 x 12 x 12, the reference's 25 components and
     7,737 swept nodes, sweep and host build timed), per correlation T,
     kept modes, ranks, dc_max and probe_err (vega_tpu's 5 x budget
     warning line reported), every correlation grid-served on the card;
   - warm build: a second interface loads the payload from the cache with
     no kernel launch and serves a bit-equal chi2_batch;
   - the port's dense chi^2 and gradient against the JAX dense goldens
     (1e-8), the grid chi^2 against them (the gate 5e-3 + 1e-9 |chi2|,
     vega_tpu's node-convergence floor, reported: the miss is
     sigma_velo's 12 nodes, ROADMAP.md section 3), rates
     at 8192 / 32768 in bench.py's JSON shape, a profile of one call;
   - minimize() on the payload from the start of TABLE6_SAMPLE, its
     results written with vega.output.write_results and read back with
     FitResults bit for bit (values, errors, covariance, FVAL, MODEL
     columns);
   - run_vega_mc.main then run_vega_mc_fits.main on the MOCKS it wrote
     (the fit configuration with [monte carlo] over bias_LYA, beta_LYA,
     64 mocks): the two Bestfit tables within 1e-10 relative;
   it fails unless the sweep launched F_0 (the metal stack's too) at
   its layouts, each held against its plain version.
11. eBOSS DR16 as published (phase dr16pub), configuration
   synthetic-dr16-published-full: the combined fit that
   examples/eBOSS_DR16/make_configs.py builds (testing.
   make_dr16_published_dataset): four correlations (lyaxlya, lyaxlyb
   2500 bins, lyaxqso, lybxqso 5000 bins), old_fftlog (the legacy
   Hamilton-2000 operators on their own knot grid), old_growth_func,
   binsize 4, the sky-residual broadband in both autos, five metals with
   CIV(eff), the 18 sampled names and their priors, against
   tests/data/torch_port_dr16pub_goldens.json:
   - dense regime: chi^2 at the truth (its priors' chi^2), chi2_batch on
     8192 rows of the 18 names (1e-8 relative against the JAX dense
     chi^2; kernel vs plain route 1e-10), value and gradient at two
     points (1e-8), evals/s, peak memory and the device shares of the
     power-spectrum grids, the legacy transform's GEMMs, the combine, the
     metal stacks and the broadband (CUDA events);
   - vega_tpu's route for the names: the 4-dimension payload over (ap,
     at, drp_QSO, sigma_velo_disp_lorentz_QSO) swept cold into an empty
     cache; the crosses served from it, the autos (their sky terms read
     sampled names) densely: sweep and host time, T, kept modes,
     dc_max, probe_err; chi2_batch at 8192 / 32768, kernels and idle
     share of one call; the grid against the JAX dense chi^2 at the
     golden points, reported (the sigma_velo node convergence of
     ROADMAP.md section 3); a warm interface loads the payload with no
     launch and serves a bit-equal chi2_batch;
   - minimize() in that route (calls, wall time; the dense chi^2 at its
     best fit against the JAX dense fit's, reported); the dense fit of
     this configuration is the run_vega phase's (`cli fit`, held against
     the same JAX dense fit);
   it fails unless the metal stacks launched F_0 on the dense path and
   in the sweep, each launch layout (the legacy knot grid's among them)
   held against its plain version. The legacy knot grid also joins the
   edge layouts.
12. DESI DR1's baseline as run on mocks (phase desi_mock), configuration
   synthetic-desi-mock-full (testing.make_desi_mock_dataset; examples/
   DESI_mock_setup): the DESI model with Gaussian full-shape smoothing in
   [model] and [metals] at fixed widths, no Arinyo term, no instrumental
   systematics, new-metals matrices of the four Si lines, per-correlation
   covariances, DESI_MOCK_FIT_SAMPLE's 15 names, against the desi_mock
   part of tests/data/torch_port_mocks_goldens.json:
   - dense regime: chi^2 at the defaults, chi2_batch(8192) (finite;
     kernel vs plain route 1e-10), the JAX dense chi^2 at 8 points and
     value and gradient at 2 (1e-8), evals/s, peak memory and the device
     shares of the metal matrices, the metal stacks' combine and the
     power-spectrum grids (the smoothing among them);
   - grid regime (the widths fixed, so both correlations stay factored):
     DESI_MOCK_GRID_NAMES on 32 x 32 nodes, the cold build, T, modes and
     ranks against the JAX payload's, chi2_batch against the JAX grid
     chi^2 (2e-4 + 1e-9 |chi2|), evals/s at 8192 / 32768, and minimize()
     on the payload against the JAX grid fit (values 1e-2 / errors 1e-3 of
     the JAX errors);
   it fails unless the metal stacks launched F_0 on both paths.
13. The LyaCoLoRe raw-mock auto (phase lyacolore), configuration
   synthetic-lyacolore-full (testing.make_lyacolore_dataset; examples/
   lyacolore_mocks): LYA x LYA on the DR9LyaMocks template (old_fftlog),
   Gaussian smoothing with par_sigma_smooth and per_sigma_smooth
   sampled beside ap, at, bias_LYA and beta_LYA, against the lyacolore
   part of the goldens:
   - vega_tpu's route for the six names: the sweep over (ap, at) finds the
     auto dense (the smoothing reads sampled widths), so the payload is
     empty and every call dense; its sweep time and chi2_batch(8192);
   - dense regime: as desi_mock's (the power-spectrum grids' and the
     combine's shares);
   - minimize() over the six names against the JAX dense fit (1e-2 / 1e-3
     of the JAX errors); it fails unless the fit launched F_d (d >= 1),
     P_d and Ft_d.
14. A fit from the command line (phase run_vega), configuration
   synthetic-dr16-published-full with the components written
   (make_dr16_published_dataset(..., components=True): [output] write_pk
   and write_cf, fast_metals and fast_metal_bias off, which both packages
   require) on phase dr16pub's template, data and metal files
   (files_from), against tests/data/torch_port_run_vega_goldens.json:
   - `vega_tpu_torch.cli fit main.ini --device cuda` (run_vega: the
     interface, vega_tpu's route for the 18 names, which sweeps and finds
     nothing factored once the metals run unrolled, the fit, the results
     file, and the wedge and shell plots where matplotlib is installed,
     decided before the call), timed; the best fit against the JAX dense
     fit of the dr16pub goldens (1e-2 / 1e-3 of the JAX errors);
   - the results file read back: MODEL_*, BESTFIT, PK_* and Xi_* of the
     four correlations, the MODEL_ models and BESTFIT's names, values,
     errors and covariance equal to the in-memory fit and every
     component column to the in-memory component, bit for bit;
     bao_amp x peak + smooth against the best-fit model (1e-12);
   - the components at the goldens' point, the metal pairs' own
     (model.metals) among them, against vega_tpu's (1e-10 of max|ref|
     at 64 indices and in norm);
   - compute_sensitivity_exact over the 18 names at the goldens' nominal
     (1e-9) and compute_sensitivity over (ap, at, bias_eta_LYA,
     beta_LYA), 8 rebuilds (1e-8), partials and Fisher sums;
   it fails unless the exact Jacobian launched F_0, a kernel of order
   d >= 1 and the transpose.

Each path runs with the kernels' launch counts set to 0 just before it,
and fails if the forward kernel was not launched. Every kernel launch a
path makes (the forward F_d, the no-sum mode P_d and the transpose Ft_d
of csrc/spline_legendre_combine.cu, with d its derivative order) is
recorded with its layout (B, G, coordinate rows, M, shared coordinates)
and counted as it runs (ops.spline_combine.recorded_launches); right
after, each kernel is held against its plain PyTorch version at each of
those layouts (random tables, about 5% of the queries outside the knot
range), max|diff| <= 1e-12 max|ref| (1e-5 for the f32 kernels), the
transpose also bit for bit
against a second launch. Each layout is timed: the kernel's device time
(launches queued behind a spin kernel), one wrapper call and the plain
version (CUDA events), beside the layout's bytes and bound (HBM bytes at
3.35 TB/s) and its launches in the path's run; a layout an earlier path
held on the same knot grid keeps that check. After the dense path,
every kernel (d = 0..3) is held the same way at edge layouts: every
query on a knot, every query in one interval, M not a multiple of the
tile, B = 1 with M = 1, a row with every query out of range. Any failure
exits non-zero.
tests/tools/compare_combine_designs.py reads the layouts off the kernels'
JSON record to time another checkout's kernels against these in turns.
The last three lines of standard output are the kernels' JSON record,
the nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_goldens.json'
GRID_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_grid_goldens.json'
FIT_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_fit_goldens.json'
MC_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_mc_goldens.json'
SAMPLER_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_sampler_goldens.json'
DR16_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_dr16_goldens.json'
DESI_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_desi_goldens.json'
TABLE6_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_table6_goldens.json'
TABLE6_REFERENCE = ROOT / 'benchmarks' / 'table6_accuracy.json'
DR16PUB_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_dr16pub_goldens.json'
MOCKS_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_mocks_goldens.json'
RUN_VEGA_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_run_vega_goldens.json'
UV_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_uv_goldens.json'
MARG_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_marg_goldens.json'
# the marg phase's template coefficients against the JAX package's, of
# their largest entry (PERF.md section 2)
MARG_COEFF_RTOL = 1e-8
F32_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_f32_goldens.json'
# the f32 mode against vega_tpu's f32 ladder (tests/test_f32_mode.py:
# 106-109: |d chi2| <= 0.3 and <= 3e-4 |chi2|, both held there on chi^2
# of ~200-3,300, where the two parts meet at chi^2 = 1,000): here
# |d chi2| <= max(0.3, 3e-4 |chi2|), the absolute part below 1,000 (rows
# near the truth, chi^2 ~ 10, differ by ~0.01) and the relative part
# above it (f32 sums of chi^2 ~ 3e4 differ by ~0.5, vega_tpu's own f32
# from its f64 by 0.68 at 73,016); best fits within 1e-2 of the JAX
# errors
F32_CHI2_ABS, F32_CHI2_REL = 0.3, 3e-4
F32_FIT_SIGMA = 1e-2
# the run_vega phase against the JAX goldens, each of the largest entry of
# the reference vector: the saved components at the goldens' point, the
# exact partials (and the Fisher sums, of the sum of their bins'
# absolute values), the central differences; bao_amp x peak + smooth
# against the returned model
COMPONENT_RTOL = 1e-10
SENSITIVITY_EXACT_RTOL = 1e-9
SENSITIVITY_FD_RTOL = 1e-8
COMPONENT_SUM_RTOL = 1e-12
# the payload's node-convergence floor against the dense chi^2 (vega_tpu
# measured 1.6e-3 at most on the reference data, docs/performance.md:
# 178-181) and vega_tpu's warning line for the held-out probe bound
# (5 x the mode budget, vega_tpu/gridcollapse.py:1090)
TABLE6_DENSE_ABS, TABLE6_DENSE_REL = 5e-3, 1e-9
PROBE_BUDGETS = 5.0
TABLE6_MC_MOCKS = 64
MC_TABLE_RTOL = 1e-10

KERNEL_TOL = 1e-12      # max|kernel - plain| <= KERNEL_TOL * max|plain|
# the same for an f32 kernel against its f32 plain version: the two sum
# in other orders (tests/test_torch_f32_kernels.py holds the plain
# version to the Pallas kernels at 1e-5 of max|ref|)
F32_KERNEL_TOL = 1e-5
CALL_REPEATS = 3        # a wrapper call's time: median of 3 means of 20
PLAIN_RTOL = 1e-10      # chi2_batch, kernel path vs plain path
GOLDEN_RTOL = 1e-8      # chi2_batch vs the JAX package's dense chi^2
DEFAULT_CHI2_MAX = 1e-6
BATCH = 8192
TIMED_ROUNDS = 3
# grid chi^2 vs the JAX grid chi^2: vega_tpu's default per-correlation
# mode budget, plus round-off of the chi^2 itself
GRID_ABS_TOL = 2e-4
GRID_REL_TOL = 1e-9
GRID_BATCHES = (8192, 32768)
GRID_ROUNDS = 5          # bench.py's median of 5
# the fit phase, against the JAX fit goldens (relative to the largest
# entry of each chi^2, gradient or Hessian). The grid path serves the
# port's own payload, held to the JAX one within the 2e-4 chi^2 mode
# budget; the dense path differs from the JAX package's by round-off.
FIT_GRID_RTOL = 1e-6
FIT_DENSE_RTOL = 1e-8
KERNEL_GRAD_RTOL = 1e-10     # use_kernel=True vs False, gradients
KERNEL_HESS_RTOL = 1e-9      # and Hessians
# best fits: |d value| <= FIT_VALUE_SIGMA x the JAX error, errors within
# FIT_ERROR_RTOL, |d fval| <= FIT_FVAL_ABS
FIT_VALUE_SIGMA = {'grid': 1e-2, 'dense': 1e-3, 'joint': 1e-2,
                   'published': 1e-2, 'mock': 1e-2}
FIT_ERROR_RTOL = {'grid': 1e-3, 'dense': 1e-5, 'joint': 1e-3,
                  'published': 1e-3, 'mock': 1e-3}
FIT_FVAL_ABS = {'grid': GRID_ABS_TOL, 'dense': 1e-8, 'joint': 1e-4,
                'published': 1e-4, 'mock': 1e-4}
# the desi phase's global mock against the JAX one: the same numpy draw
# around each package's own best fit; its dense calls take 1.6 s each, so
# two timed rounds
MOCK_RTOL = 1e-8
DESI_TIMED_ROUNDS = 2
# the scan and MC phases: mocks per campaign, the torch generator's seed,
# and the fit chunks (VEGA_TPU_FIT_CHUNK_PER_DEVICE): vega_tpu's default 8
# beside the whole campaign in one chunk; a larger dense campaign in one
# chunk gives the peak memory's growth per row (32 and 512 mocks: half
# the earlier 64 and 1024, to make room for the dr16 phase)
MC_DENSE_MOCKS = 32
MC_DENSE_PROBE_MOCKS = 512
MC_COLLAPSE_MOCKS = 256
MC_SEED = 0
DEFAULT_FIT_CHUNK = 8
# golden mock fits: values within MC_VALUE_SIGMA of the JAX errors,
# errors within MC_ERROR_RTOL, chi^2 within MC_CHI2_ABS, valid equal
MC_VALUE_SIGMA, MC_ERROR_RTOL, MC_CHI2_ABS = 1e-3, 1e-5, 1e-8
# rows are independent: a scan point's fval in chunks of 8 vs in one chunk
# differs only by round-off in the last Newton steps
SCAN_CHUNK_FVAL_ABS = 1e-8
# the default-chunk scan runs on this corner of the 40 x 40 grid (100
# points in 13 chunks of 8: the whole grid took 28 s of a run that now
# also drives the samplers)
SCAN_DEFAULT_CHUNK_CORNER = 10
# the sampler phase. NS takes the goldens' [NestedJax] settings. Posterior
# mean within NS_MEAN_SIGMA of the fit goldens' errors of their grid best
# fit, posterior sigma within NS_STD_RTOL of those errors (SMC and HMC:
# twice that, as the JAX package's tests allow); a chain's -2 ln L column
# against log_lik_batch; a replayed evolution against the eager one
NS_MEAN_SIGMA, NS_STD_RTOL = 0.5, 0.3
SAMPLER_LOGL_RTOL = 1e-9
EVOLVE_LOGL_RTOL = 1e-12
NS_HOST_ITERATIONS = 3
SMC_SETTINGS = {'n_effective': 512, 'n_mcmc': 5, 'seed': 0}
HMC_GRID_SETTINGS = {'num_chains': 32, 'num_warmup': 200,
                     'num_samples': 200, 'num_leapfrog': 16, 'seed': 0}
HMC_DENSE_SETTINGS = {'num_chains': 32, 'num_warmup': 20, 'num_samples': 20,
                      'num_leapfrog': 8, 'seed': 0}
# the dense log-likelihood's evolution as a graph: chains, repeats,
# shrink steps
NS_DENSE_SHAPE = (8, 2, 3)


def fail(message):
    raise SystemExit(f'chip_smoke FAILED: {message}')


def log(message):
    print(message, flush=True)


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit` for the card in use."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    index = torch.cuda.current_device()
    return lines[index] if index < len(lines) else lines[0]


def cuda_time_ms(fn, iters, repeats=1):
    """Time per call of fn() in ms, from CUDA events around `iters` calls
    after one warm call (the host's issue time included where it is the
    longer); the median of `repeats` such means."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / iters)
    return float(np.median(means))


# ----------------------------------------------------------------------
def build_kernels():
    from vega_tpu_torch.ops._build import load_library
    t0 = time.perf_counter()
    built = load_library()
    log(f'build: {built.path.name} '
        f'({"compiled" if built.built else "found on disk"}) in '
        f'{time.perf_counter() - t0:.2f} s')
    for line in built.log.splitlines():
        if ('registers' in line or 'smem' in line or 'spill' in line
                or 'Compiling entry' in line):
            log(f'  ptxas: {line.strip()}')
    return built


def random_case(rng, device, grid, layout):
    """Random inputs of one recorded launch layout: tables with their
    not-a-knot second derivatives, queries with about 5% outside the
    knot range, Legendre weights (or the transpose's g) in [-1, 1];
    shared rows with row stride 0."""
    from vega_tpu_torch.ops.spline import notaknot_second_derivative_matrix
    n_b, n_ell, n_knots, group, n_x, n_q, x_shared, leg_shared = layout[:8]
    logr = grid.values
    span = logr[-1] - logr[0]

    def tensor(a):
        return torch.as_tensor(a, dtype=grid.dtype, device=device)

    y_np = rng.normal(size=(n_b, n_ell, n_knots))
    y = tensor(y_np)
    m = tensor(y_np @ notaknot_second_derivative_matrix(logr).T)
    x = tensor(rng.uniform(logr[0] - 0.025 * span, logr[-1] + 0.025 * span,
                           (1 if x_shared else n_x, n_q))).expand(n_x, n_q)
    leg = tensor(rng.uniform(-1, 1, (1 if leg_shared else n_x, n_ell,
                                     n_q))).expand(n_x, n_ell, n_q)
    g = tensor(rng.uniform(-1, 1, (n_b, n_q)))
    return y, m, x, leg, g


def device_ms(fn, iters, spin_cycles=50_000_000):
    """Mean device time per call of fn() in ms: CUDA events around
    `iters` calls queued behind a spin kernel (torch.cuda._sleep) that
    holds the stream while the host queues them, so they run back to back
    on the device with no host time between them (one warm call first).
    The spin doubles until it outlasts the host's queueing."""
    fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(6):
        torch.cuda.synchronize()
        events[0].record()
        torch.cuda._sleep(spin_cycles)
        events[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        events[2].record()
        torch.cuda.synchronize()
        if events[0].elapsed_time(events[1]) > host_ms:
            break
        spin_cycles *= 2
    return events[1].elapsed_time(events[2]) / iters


def kernel_call(primitive, order, grid, group, y, m, x, leg, g):
    """run(use_kernel) -> the outputs of one primitive, as a tuple."""
    from vega_tpu_torch.ops import spline_combine as sc
    if primitive == 'F':
        return lambda use_kernel: (sc.combine_forward(
            grid, y, m, x, leg, order=order, group=group,
            use_kernel=use_kernel),)
    if primitive == 'P':
        return lambda use_kernel: (sc.combine_points(
            grid, y, m, x, order=order, group=group,
            use_kernel=use_kernel),)
    return lambda use_kernel: sc.combine_transpose(
        grid, g, x, leg, order=order, use_kernel=use_kernel)


def hold(run, primitive, label, tol=KERNEL_TOL):
    """The kernel against its plain version, max|diff| <= tol max|ref|
    (KERNEL_TOL in f64, F32_KERNEL_TOL in f32); the transpose also bit
    for bit against a second launch. Returns (max|diff|, max|ref|)."""
    out, ref = run(True), run(False)
    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = max(float(r.abs().max()) for r in ref)
    if not err <= tol * scale:
        fail(f'kernel disagrees with its plain version ({label}): '
             f'max|diff| {err:.3e} > {tol:g} x {scale:.3e}')
    if primitive == 'Ft':
        again = run(True)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f'two launches of the transpose differ ({label}): it is '
                 'meant to be bitwise reproducible')
    return err, scale


def layout_dtype(layout):
    """'f64', or 'f32' for an f32 launch's layout (its ninth entry)."""
    return layout[8] if len(layout) > 8 else 'f64'


def layout_label(primitive, order, layout):
    n_b, n_ell, n_knots, group, n_x, n_q, x_shared, leg_shared = layout[:8]
    return (f'{primitive}_{order} B={n_b} L={n_ell} N={n_knots} G={group} '
            f'M={n_q}, {n_x} coordinate row(s)'
            f'{" (x stride 0)" if x_shared else ""}'
            f'{" (leg stride 0)" if leg_shared else ""}'
            f'{" f32" if layout_dtype(layout) == "f32" else ""}')


def twin_defined(primitive, order):
    """Whether an f32 kernel's output is compared with the f64 kernel's:
    an f32 query near a knot may fall in the interval beside the one its
    f64 value falls in, which moves nothing where the output is
    continuous across knots (F_d and P_d for d <= 2, Ft_0 and Ft_2) and
    moves whole slot values where it is not (S''' in F_3 and P_3, the
    +-1/h weights of Ft_1 and Ft_3)."""
    return order <= 2 and (primitive != 'Ft' or order != 1)


def f64_twin(device, grid, primitive, order, group, inputs):
    """run(use_kernel) of the f64 kernel on an f32 case's inputs (cast up)
    and its knots in f64: what the f32 kernel is reported against."""
    from vega_tpu_torch.ops.spline_combine import KnotGrid
    grid64 = KnotGrid.build(grid.values, device)
    return kernel_call(primitive, order, grid64, group,
                       *(t.double() for t in inputs))


def vs_f64(out32, run64):
    """max|f32 kernel - f64 kernel| / max|f64 kernel| on the same
    inputs."""
    out64 = run64(True)
    return max(float((a.double() - b).abs().max()) for a, b in
               zip(out32, out64)) / max(float(b.abs().max()) for b in out64)


# every (kernel, layout, knot grid) held and timed so far in this run:
# {key: (path, record)}; a later path that launches the same layout takes
# the earlier check (most layouts recur from phase to phase: 231 of the
# 407 layout records of a whole run repeat an earlier path's)
CHECKED = {}


def check_launches(device, path, layouts):
    """Hold each kernel against its plain version at every launch layout
    a path recorded, on the path's knot grid (random inputs,
    `random_case`; `hold`), and time it: `ms` its device time per launch
    (`device_ms`), `call_ms` one wrapper call on CUDA events with the
    host's issue time (median of CALL_REPEATS means of 20 calls),
    `plain_ms` the plain version (a mean of 5 calls). Beside them
    the layout's launches in the path's run, its bytes and bound
    (spline_combine.launch_bound: HBM bytes at 3.35 TB/s bound every
    layout) and the share of the bound the kernel reaches. A layout an
    earlier path of the run already held on the same knot grid keeps
    that check (`held_in` names the path) with this path's launches.
    Returns one record per layout, largest B * M first, with its knot
    range (the grid is uniform: first and last knot and N give it)."""
    from vega_tpu_torch.ops.spline_combine import launch_bound, launch_bytes

    rng = np.random.default_rng(0)
    records = []
    for key in sorted(layouts, key=lambda k: (k[0], k[1], -k[2] * k[7])):
        primitive, order, *layout = key
        grid, launches = layouts[key].grid, layouts[key].launches
        grid_key = (key, len(grid.values), float(grid.values[0]),
                    float(grid.values[-1]))
        if grid_key in CHECKED:
            held_in, held = CHECKED[grid_key]
            log(f'kernel check {path} '
                f'{layout_label(primitive, order, layout)}: as held in '
                f'{held_in} (max|diff| {held["max_abs_err"]:.3e}, kernel '
                f'{held["ms"]:.4f} ms on the device), {launches} launches '
                'in the run')
            records.append({**held, 'path': path, 'launches': launches,
                            'held_in': held_in})
            continue
        dtype = layout_dtype(layout)
        y, m, x, leg, g = random_case(rng, device, grid, layout)
        group = layout[3]
        run = kernel_call(primitive, order, grid, group, y, m, x, leg, g)
        label = f'{path} {layout_label(primitive, order, layout)}'
        err, scale = hold(run, primitive, label, F32_KERNEL_TOL
                          if dtype == 'f32' else KERNEL_TOL)
        twin = None if dtype == 'f64' or not twin_defined(
            primitive, order) else vs_f64(
            run(True), f64_twin(device, grid, primitive, order, group,
                                (y, m, x, leg, g)))
        plain_ms = cuda_time_ms(lambda: run(False), 5)
        call_ms = cuda_time_ms(lambda: run(True), 20, CALL_REPEATS)
        ms = device_ms(lambda: run(True), 20)
        bound_ms, bound_by = launch_bound(primitive, order, *layout)
        n_b, _, _, _, n_x, n_q, x_shared, leg_shared = layout[:8]
        log(f'kernel check {label}: max|diff| {err:.3e} (max|ref| '
            f'{scale:.3e}); kernel {ms:.4f} ms on the device (a call '
            f'{call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound '
            f'{bound_ms:.5f} ms ({bound_by}, {bound_ms / ms:.1%}), '
            f'{launches} launches in the run'
            + ('' if twin is None else f'; against the f64 kernel on the '
               f'same inputs {twin:.3e} of max|f64| (reported)'))
        records.append({'path': path, 'primitive': primitive,
                        'order': order, 'dtype': dtype, 'vs_f64': twin,
                        'B': n_b, 'G': group,
                        'coordinate_rows': n_x, 'M': n_q,
                        'x_shared': x_shared, 'leg_shared': leg_shared,
                        'layout': list(layout),
                        'knots': [float(grid.values[0]),
                                  float(grid.values[-1])],
                        'launches': launches,
                        'max_abs_err': err, 'max_abs_ref': scale,
                        'ms': ms, 'call_ms': call_ms,
                        'plain_ms': plain_ms,
                        'bytes': launch_bytes(primitive, order, *layout),
                        'bound_ms': bound_ms, 'bound_by': bound_by,
                        'share_of_bound': bound_ms / ms})
        CHECKED[grid_key] = (path, records[-1])
    return records


def edge_cases(rng, device, grid, n_ell):
    """Layouts that corner the kernels, on `grid`, as [(label, layout,
    (y, m, x, leg, g))] with per-row coordinates: every query on a knot
    (both ends included), every query in one interval (the transpose's
    longest run), M not a multiple of the tile (odd and even M), B = 1
    with M = 1, and a row with every query out of range (half below,
    half above)."""
    knots = grid.values
    n_knots = len(knots)
    span = knots[-1] - knots[0]

    def uniform(n_b, n_q):
        return rng.uniform(knots[0], knots[-1], (n_b, n_q))

    on_knots = knots[rng.integers(0, n_knots, (2, 3000))]
    on_knots[:, :2] = knots[0], knots[-1]
    mid = n_knots // 2
    out_of_range = uniform(3, 2000)
    out_of_range[1] = np.where(
        rng.random(2000) < 0.5,
        knots[0] - rng.uniform(1e-3, 0.1, 2000) * span,
        knots[-1] + rng.uniform(1e-3, 0.1, 2000) * span)
    coords = [('every query on a knot', on_knots),
              ('every query in one interval',
               rng.uniform(knots[mid], knots[mid + 1], (2, 3000))),
              ('M not a multiple of the tile (odd M)', uniform(3, 5001)),
              ('M not a multiple of the tile (even M)',
               uniform(150, 2000)),
              ('B = 1, M = 1', uniform(1, 1)),
              ('a row with every query out of range', out_of_range)]
    cases = []
    for label, x_np in coords:
        n_b, n_q = x_np.shape
        layout = (n_b, n_ell, n_knots, 1, n_b, n_q, False, False)
        if grid.dtype == torch.float32:
            layout += ('f32',)
        y, m, _, leg, g = random_case(rng, device, grid, layout)
        x = torch.as_tensor(x_np, dtype=grid.dtype, device=device)
        cases.append((label, layout, (y, m, x, leg, g)))
    return cases


def legacy_knot_grid(device, main_ini):
    """The old_fftlog knot grid of the configuration's k grid (the
    legacy Hamilton-2000 operators' log r - dr/2)."""
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.ops.spline_combine import KnotGrid
    from vega_tpu_torch.pktoxi import hamilton_operators
    from vega_tpu_torch.vega_interface import parse_ini
    template = parse_ini(main_ini)['fiducial']['filename']
    k = read_fits(template)[1]['K'].astype(np.float64)
    return KnotGrid.build(hamilton_operators(k, (0,), 2, True)[1], device)


def check_edge_layouts(device, grid, n_ell, grid_label='mcfit'):
    """Every kernel (F_d, P_d, Ft_d, d = 0..3) of the grid's dtype
    against its plain version at each of `edge_cases` on `grid` (named
    `grid_label`); the transpose also bit for bit against a second
    launch; an f32 kernel also against the f64 kernel where
    `twin_defined` (reported). Returns one record per kernel and case."""
    rng = np.random.default_rng(1)
    records = []
    dtype = 'f32' if grid.dtype == torch.float32 else 'f64'
    for label, layout, inputs in edge_cases(rng, device, grid, n_ell):
        label = f'{label} ({grid_label} knots{", f32" * (dtype == "f32")})'
        worst = twin = 0.0
        for primitive in ('F', 'P', 'Ft'):
            for order in range(4):
                run = kernel_call(primitive, order, grid, 1, *inputs)
                err, scale = hold(run, primitive, f'edge layout {label}, '
                                  f'{layout_label(primitive, order, layout)}',
                                  F32_KERNEL_TOL if dtype == 'f32'
                                  else KERNEL_TOL)
                worst = max(worst, err / scale if scale else err)
                if dtype == 'f32' and twin_defined(primitive, order):
                    twin = max(twin, vs_f64(run(True), f64_twin(
                        device, grid, primitive, order, 1, inputs)))
                records.append({'path': 'edge', 'case': label,
                                'primitive': primitive, 'order': order,
                                'dtype': dtype, 'layout': list(layout),
                                'max_abs_err': err, 'max_abs_ref': scale})
        log(f'edge layout {label} (B={layout[0]}, M={layout[5]}): F_d, P_d, '
            f'Ft_d (d = 0..3) agree with their plain versions, worst '
            f'max|diff| / max|ref| {worst:.3e}; Ft_d bitwise reproducible'
            + (f'; against the f64 kernels {twin:.3e} (reported; those '
               'continuous across knots, `twin_defined`)'
               if dtype == 'f32' else ''))
    return records


@contextlib.contextmanager
def switch(name, value):
    """Set (or with None, unset) an environment switch the interface reads
    at construction, restoring it afterwards."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def draw_batch(n_rows):
    """(bias_LYA, beta_LYA, ap, at) rows as bench.py:186-192 draws them."""
    sampled = {'bias_LYA': -0.117, 'beta_LYA': 1.67, 'ap': 1.0, 'at': 1.0}
    rng = np.random.default_rng(0)
    return {name: val + 0.01 * np.abs(val) * rng.normal(size=n_rows)
            for name, val in sampled.items()}


def run_dense_path(device, main_ini):
    """The dense path (VEGA_TPU_FACTORED=0) on the full configuration;
    returns the kernel launches of its run, the kernel checks at its
    layouts and its knot grid."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import CHUNK_ROWS, VegaInterface

    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        vega = VegaInterface(main_ini, device=device)
    log(f'dense path: interface in {time.perf_counter() - t0:.2f} s; bins '
        + ', '.join(f'{n} {d.full_data_size} ({d.data_size} unmasked)'
                    for n, d in vega.data.items()))
    batches = draw_batch(BATCH)

    # the dense path's run: counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        chi2_default = vega.chi2()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = check_launches(device, 'dense', layouts)

    log(f'chi2 at the defaults: {chi2_default!r}')
    if not abs(chi2_default) < DEFAULT_CHI2_MAX:
        fail(f'chi2 at the defaults {chi2_default!r} >= {DEFAULT_CHI2_MAX}')
    chi2_np = chi2.cpu().numpy()
    if chi2_np.shape != (BATCH,) or not np.all(np.isfinite(chi2_np)):
        fail('chi2_batch is not finite of shape (8192,)')
    if np.any(chi2_np >= 1e100):
        fail(f'{int(np.sum(chi2_np >= 1e100))} rows took the penalty')
    expected = len(vega.models) * 2 * (-(-BATCH // CHUNK_ROWS) + 1)
    log(f'chi2_batch({BATCH}): first call {first_s:.3f} s, peak device '
        f'memory {peak_gb:.2f} GB, chi2 in [{chi2_np.min():.6g}, '
        f'{chi2_np.max():.6g}], kernel launches {launches} '
        f'(expected {expected} of F_0)')
    if not launches.get(('F', 0)):
        fail('the dense path launched no spline_legendre_combine kernel')

    plain = vega.chi2_batch(batches, use_kernel=False).cpu().numpy()
    rel = float(np.max(np.abs(plain - chi2_np) / np.abs(plain)))
    log(f'kernel path vs plain path: max relative diff {rel:.3e}')
    if not rel <= PLAIN_RTOL:
        fail(f'kernel path vs plain path differ by {rel:.3e} > {PLAIN_RTOL}')

    goldens = json.loads(GOLDENS.read_text())
    got = vega.chi2_batch(goldens['params']).cpu().numpy()
    want = np.asarray(goldens['chi2'])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f'vs JAX goldens ({len(want)} points): max relative diff {rel:.3e}')
    if not rel <= GOLDEN_RTOL:
        fail(f'chi2 vs the JAX goldens differ by {rel:.3e} > {GOLDEN_RTOL}')

    for use_kernel in (True, False):
        times = []
        for _ in range(TIMED_ROUNDS):
            for name in batches:
                batches[name] = batches[name] + 1e-6
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            vega.chi2_batch(batches, use_kernel=use_kernel)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        log(f'chi2_batch({BATCH}) {"kernel" if use_kernel else "plain"} '
            f'path: {BATCH / np.median(times):.1f} evals/s '
            f'(median of {TIMED_ROUNDS}, s per call '
            f'{", ".join(f"{t:.4f}" for t in times)})')
    return launches, records, next(iter(layouts.values())).grid


def profile_call(label, fn, device):
    """torch.profiler over one warm call of fn(): device kernel time, the
    span from the first kernel's start to the last one's end, and the
    top kernels by time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f'profile {label}: no device events recorded (not measured)')
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    log(f'profile {label}: {len(kernels)} kernels, {busy_ms:.4f} ms of '
        f'kernel time in a {span_ms:.4f} ms span (device idle '
        f'{max(0.0, 1 - busy_ms / span_ms):.1%})')
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:8]:
        log(f'  {ms:9.4f} ms  x{count:<4d} {name[:90]}')


def run_grid_path(device, main_ini, card):
    """bench.py's regime: the grid collapse on the full configuration
    with its defaults; returns the kernel launches of its run and the
    kernel checks at its layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(GRID_GOLDENS.read_text())
    names = frozenset(['ap', 'at', 'bias_LYA', 'beta_LYA'])
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        vega = VegaInterface(main_ini, device=device)
    batches = draw_batch(BATCH)

    # the grid path's run: counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        payload = vega.get_collapsed(names)
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        sweep_launches = LAUNCHES[('F', 0)]
        chi2 = vega.chi2_batch(batches).cpu().numpy()
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = check_launches(device, 'grid', layouts)

    spec = payload['__grid__']
    stats = vega.grid_stats
    log(f'grid collapse: {spec}, {stats["nodes"]} nodes; chi^2 constants '
        f'(host inverse covariances) {stats["constants_s"]:.3f} s, device '
        f'sweep {stats["sweep_s"]:.3f} s, host payload build '
        f'{stats["host_s"]:.3f} s, total {collapse_s:.3f} s; kernel '
        f'launches {sweep_launches} in the sweep, {launches} in the run; '
        f'peak device memory {peak_gb:.3f} GB')
    for name in vega.corr_items:
        if name not in payload:
            fail(f'{name} is not served by the grid payload')
        p = payload[name]
        want = goldens['payload'][name]
        log(f'  {name}: T = {p["cref"].shape[0]}, retained modes '
            f'A {p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
            f'SVD rank A {p["B_A"].shape[1]} / sy {p["B_sy"].shape[1]} '
            f'(JAX package: modes {want["modes_A"]} / {want["modes_sy"]}, '
            f'rank {want["rank_A"]} / {want["rank_sy"]}), dc_max '
            f'{float(p["dc_max"]):.6g}')
    if sweep_launches == 0:
        fail('the grid sweep launched no spline_legendre_combine kernel')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)):
        fail(f'grid chi2_batch is not finite of shape ({BATCH},)')
    if np.any(chi2 >= 1e100):
        fail(f'{int(np.sum(chi2 >= 1e100))} grid rows took the penalty')
    log(f'grid chi2_batch({BATCH}): chi2 in [{chi2.min():.6g}, '
        f'{chi2.max():.6g}]')

    got = vega.chi2_batch(goldens['params']).cpu().numpy()
    want_grid = np.asarray(goldens['chi2_grid'])
    want_dense = np.asarray(goldens['chi2_dense'])
    d_grid = np.abs(got - want_grid)
    bound = GRID_ABS_TOL + GRID_REL_TOL * np.abs(want_grid)
    log(f'vs JAX grid goldens ({len(got)} points): max |d chi2| '
        f'{d_grid.max():.3e} (bound {bound.min():.3e} .. {bound.max():.3e})')
    if not np.all(d_grid <= bound):
        fail(f'grid chi2 vs the JAX grid chi2: |d| {d_grid.max():.3e} '
             'over the bound')
    dense_bound = goldens['max_abs_grid_minus_dense'] + GRID_ABS_TOL
    d_dense = float(np.max(np.abs(got - want_dense)))
    log(f'vs JAX dense chi2: max |d chi2| {d_dense:.6g} (bound '
        f'{dense_bound:.6g}: the JAX grid path\'s own + {GRID_ABS_TOL:g})')
    if not d_dense <= dense_bound:
        fail(f'grid chi2 vs the JAX dense chi2: {d_dense:.6g} > '
             f'{dense_bound:.6g}')

    rates = {}
    for n_rows in GRID_BATCHES:
        rows = draw_batch(n_rows)
        vega.chi2_batch(rows).cpu()
        per_round, host_ms, total_ms = [], [], []
        for _ in range(GRID_ROUNDS):
            for name in rows:
                rows[name] = rows[name] + 1e-6     # as bench.py
            t0 = time.perf_counter()
            out = vega.chi2_batch(rows)
            t1 = time.perf_counter()       # the host has issued the call
            out.cpu()
            t2 = time.perf_counter()
            per_round.append(n_rows / (t2 - t0))
            host_ms.append(1e3 * (t1 - t0))
            total_ms.append(1e3 * (t2 - t0))
        rates[n_rows] = float(np.median(per_round))
        log(f'grid chi2_batch({n_rows}): {rates[n_rows]:.1f} evals/s '
            f'(median of {GRID_ROUNDS}; per round '
            f'{", ".join(f"{r:.1f}" for r in per_round)}); ms per round, '
            f'host issue / with the result fetched: '
            + ', '.join(f'{h:.3f} / {t:.3f}'
                        for h, t in zip(host_ms, total_ms)))
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f'grid path peak device memory (collapse and both batches): '
        f'{peak_gb:.3f} GB')
    log(json.dumps({
        'metric': 'likelihood evals/sec/chip',
        'value': round(rates[BATCH], 3),
        'unit': f'evals/s/chip (batch={BATCH}, f64, 1 chip(s), {card}, '
                f'vega_tpu_torch, collapse={collapse_s:.1f}s; batch '
                f'{GRID_BATCHES[1]}: {rates[GRID_BATCHES[1]]:.1f})'}))
    batches = draw_batch(BATCH)
    profile_call(f'chi2_batch({BATCH})',
                 lambda: vega.chi2_batch(batches).cpu(), device)
    return launches, records


def rel_err(got, want):
    """max|got - want| / max|want|."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def derivatives_at(device, vega, points, names, label, use_kernel=True):
    """chi^2, gradient and Hessian at each point, laid out as the fit
    goldens keep them; logs the wall time of each call (synchronised),
    the first one's included."""
    out = {'chi2': [], 'gradient': [], 'hessian': []}
    times = {'value+gradient': [], 'Hessian': []}
    for point in points:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        value, grad = vega.chi2_value_and_gradient(point,
                                                   use_kernel=use_kernel)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        hess = vega.chi2_hessian(point, names, use_kernel=use_kernel)
        torch.cuda.synchronize(device)
        times['value+gradient'].append(t1 - t0)
        times['Hessian'].append(time.perf_counter() - t1)
        out['chi2'].append(value)
        out['gradient'].append([grad[n] for n in names])
        out['hessian'].append([[hess[a][b] for b in names] for a in names])
    log(f'{label}: derivatives at {len(points)} points, s per call: '
        + '; '.join(f'{kind} ' + ', '.join(f'{t:.4f}' for t in ts)
                    for kind, ts in times.items()))
    return out


def compare_derivatives(label, got, want, rtols):
    """Worst relative difference of each part over the points; fails
    above its bound. rtols: {part: bound}."""
    worst = {part: max(rel_err(g, w) for g, w in zip(got[part], want[part]))
             for part in rtols}
    log(f'{label}: max relative diff '
        + ', '.join(f'{part} {worst[part]:.3e} (bound {rtols[part]:g})'
                    for part in rtols))
    for part, bound in rtols.items():
        if not worst[part] <= bound:
            fail(f'{label}: {part} differs by {worst[part]:.3e} > {bound:g}')


def counted(fn, counts, key):
    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)
    return wrapper


def timed_fit(device, vega, label):
    """minimize() with its value+gradient and Hessian calls counted;
    returns the wall time in s and the counts."""
    counts = {'value_and_gradient': 0, 'hessian': 0, 'chi2': 0}
    mini = vega.minimizer
    mini.valgrad_func = counted(mini.valgrad_func, counts,
                                'value_and_gradient')
    mini.hess_func = counted(mini.hess_func, counts, 'hessian')
    mini.chi2_func = counted(mini.chi2_func, counts, 'chi2')
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    vega.minimize()
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    log(f'{label} fit: {seconds:.3f} s wall, {counts["value_and_gradient"]} '
        f'value+gradient calls (L-BFGS-B, Newton polish, EDM), '
        f'{counts["hessian"]} Hessians, {counts["chi2"]} chi^2 calls')
    return seconds, counts


def check_fit(label, regime, vega, names, want):
    """The port's fit against the JAX package's from the same start."""
    best = vega.bestfit
    d_sigma = max(abs(best.values[n] - v) / e for n, v, e in
                  zip(names, want['values'], want['errors']))
    d_err = max(abs(best.errors[n] / e - 1) for n, e in
                zip(names, want['errors']))
    d_fval = abs(best.fmin.fval - want['fval'])
    log(f'{label} fit vs JAX: values {[best.values[n] for n in names]} '
        f'(JAX {want["values"]}), max |d value| / error {d_sigma:.3e}, '
        f'errors max relative diff {d_err:.3e}, fval {best.fmin.fval!r} '
        f'(JAX {want["fval"]!r}), edm {best.fmin.edm:.3e}')
    if not (best.fmin.is_valid and not best.fmin.hesse_failed):
        fail(f'{label} fit is not valid')
    if not d_sigma <= FIT_VALUE_SIGMA[regime]:
        fail(f'{label} best fit differs from the JAX fit by {d_sigma:.3e} '
             f'errors > {FIT_VALUE_SIGMA[regime]:g}')
    if not d_err <= FIT_ERROR_RTOL[regime]:
        fail(f'{label} errors differ by {d_err:.3e} relative > '
             f'{FIT_ERROR_RTOL[regime]:g}')
    if not d_fval <= FIT_FVAL_ABS[regime]:
        fail(f'{label} fval differs by {d_fval:.3e} > '
             f'{FIT_FVAL_ABS[regime]:g}')


def run_fit_path(device, work):
    """The fit on the full configuration with (ap, at, bias_LYA,
    beta_LYA) sampled, in the grid regime (the defaults) and the dense
    regime (VEGA_TPU_FACTORED=0), against the JAX fit goldens; returns
    the kernel launches of each regime's run and the kernel checks at
    their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import make_synthetic_dataset
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(FIT_GOLDENS.read_text())
    names, points = goldens['names'], goldens['points']
    t0 = time.perf_counter()
    fit_ini = make_synthetic_dataset(Path(work) / 'fit', cross=True,
                                     size='full', device=device,
                                     sample=goldens['sample'])
    log(f'fit: configuration sampling {goldens["sample"]} in '
        f'{time.perf_counter() - t0:.2f} s')
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid_vega = VegaInterface(fit_ini, device=device)
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(fit_ini, device=device)

    launches = {}
    # each regime's run: counts from zero, layouts of its own
    LAUNCHES.clear()
    with recorded_launches() as grid_layouts:
        grid = derivatives_at(device, grid_vega, points, names,
                              'fit grid regime (the first call builds '
                              'the payload)')
        compare_derivatives(
            'fit grid regime vs JAX grid goldens', grid, goldens['grid'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_GRID_RTOL))
        timed_fit(device, grid_vega, 'grid')
        check_fit('grid', 'grid', grid_vega, names, goldens['fit_grid'])
    launches['fit_grid'] = dict(LAUNCHES)

    LAUNCHES.clear()
    with recorded_launches() as dense_layouts:
        dense = derivatives_at(device, dense_vega, points, names,
                               'fit dense regime')
        compare_derivatives(
            'fit dense regime vs JAX dense goldens', dense, goldens['dense'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_DENSE_RTOL))
        timed_fit(device, dense_vega, 'dense')
        check_fit('dense', 'dense', dense_vega, names, goldens['fit_dense'])
    launches['fit_dense'] = dict(LAUNCHES)
    # the plain route, for comparison: it launches nothing
    plain = derivatives_at(device, dense_vega, points, names,
                           'fit dense regime, plain combine',
                           use_kernel=False)
    compare_derivatives('fit dense regime, kernels vs plain combine', dense,
                        plain, {'chi2': KERNEL_GRAD_RTOL,
                                'gradient': KERNEL_GRAD_RTOL,
                                'hessian': KERNEL_HESS_RTOL})

    log(f'fit kernel launches: {launches}')
    dense_run = launches['fit_dense']
    if not any(n for (primitive, _), n in dense_run.items()
               if primitive == 'Ft'):
        fail('the dense fit launched no transpose kernel (Ft_d)')
    if not any(n for (_, order), n in dense_run.items() if order >= 1):
        fail('the dense fit launched no kernel of order d >= 1')
    return fit_ini, launches, (
        check_launches(device, 'fit_grid', grid_layouts)
        + check_launches(device, 'fit_dense', dense_layouts))


# ----------------------------------------------------------------------
# The f32 throughput mode (VEGA_TPU_X64=0) on synthetic-full
# ----------------------------------------------------------------------
def f32_ladder(label, got, want, enforce=True):
    """|got - want| against vega_tpu's f32 ladder: |d chi2| <=
    max(F32_CHI2_ABS, F32_CHI2_REL |chi2|) at every point; logged (the
    largest |d chi2| of up to 8 points, max |d| and max |d| / |chi2|), and
    failed when `enforce`. Returns (max |d|, max |d| / |want|)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    d = np.abs(got - want)
    worst_abs, worst_rel = float(d.max()), float(np.max(d / np.abs(want)))
    within = bool(np.all(d <= np.maximum(F32_CHI2_ABS,
                                         F32_CHI2_REL * np.abs(want))))
    log(f'{label}: |d chi2| ' + ', '.join(f'{v:.4g}' for v in d[:8])
        + (f' .. ({d.size} rows)' if d.size > 8 else '')
        + f'; max {worst_abs:.4g} at chi2 {want[np.argmax(d)]:.6g}, '
        f'relative {worst_rel:.3e} at chi2 '
        f'{want[np.argmax(d / np.abs(want))]:.6g}; gate max('
        f'{F32_CHI2_ABS:g}, {F32_CHI2_REL:g} |chi2|): '
        + ('within' if within else 'OUTSIDE')
        + ('' if enforce else ' (reported, not enforced)'))
    if enforce and not within:
        fail(f'{label}: outside vega_tpu\'s f32 ladder')
    return worst_abs, worst_rel


def f32_only(label, counts):
    """Fail unless every launch of a run went to an f32 kernel and F_0
    among them."""
    f64 = {k: n for k, n in counts.items() if len(k) == 2 and n}
    if f64 or not counts.get(('F', 0, 'f32')):
        fail(f'{label}: launches {counts}: f64 kernels, or no f32 F_0')


def run_f32_path(device, fit_ini, card):
    """Phase f32 (see the module docstring); returns the kernel launches
    of its paths and the kernel checks at their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(F32_GOLDENS.read_text())
    names, points = goldens['names'], goldens['params']
    t_phase = time.perf_counter()
    launches, checks = {}, []
    # the dense regime through VEGA_TPU_X64=0, as vega_tpu selects it,
    # beside the f64 interface on the same files
    with switch('VEGA_TPU_FACTORED', '0'):
        with switch('VEGA_TPU_X64', '0'):
            dense = VegaInterface(fit_ini, device=device)
        dense64 = VegaInterface(fit_ini, device=device)
    if dense.dtype != torch.float32 or dense64.dtype != torch.float64:
        fail(f'f32: VEGA_TPU_X64=0 gave {dense.dtype}, unset {dense64.dtype}')
    batches = draw_batch(BATCH)

    # --- dense chi2_batch(8192): counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = dense.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches['f32_dense'] = dict(LAUNCHES)
    f32_only('f32 dense', launches['f32_dense'])
    chi2_np = chi2.cpu().numpy()
    log(f'f32 dense chi2_batch({BATCH}): {chi2.dtype}, first call '
        f'{first_s:.3f} s, peak device memory '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB, chi2 in '
        f'[{chi2_np.min():.6g}, {chi2_np.max():.6g}], kernel launches '
        f'{launches["f32_dense"]}')
    if chi2.dtype != torch.float32 or not np.all(np.isfinite(chi2_np)):
        fail('f32 dense chi2_batch is not a finite float32 batch')
    checks += check_launches(device, 'f32_dense', layouts)
    f32_ladder('f32 dense, kernel vs plain combine (8192 rows)', chi2_np,
               dense.chi2_batch(batches, use_kernel=False).cpu().numpy())
    f32_ladder('f32 dense vs the f64 interface (8192 rows)', chi2_np,
               dense64.chi2_batch(batches).cpu().numpy(), enforce=False)
    got = dense.chi2_batch(points).cpu().numpy()
    f32_ladder('f32 dense vs vega_tpu\'s f32 dense goldens', got,
               goldens['chi2_dense'])
    f32_ladder('f32 dense vs vega_tpu\'s f64 dense', got,
               goldens['chi2_dense_f64'], enforce=False)
    # the two dtypes in turns: f64, f32, f32, f64
    rates = {'f64': [], 'f32': []}
    for label, vega in (('f64', dense64), ('f32', dense), ('f32', dense),
                        ('f64', dense64)):
        times = []
        for _ in range(TIMED_ROUNDS):
            for name in batches:
                batches[name] = batches[name] + 1e-6
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            vega.chi2_batch(batches)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        rates[label].append(BATCH / float(np.median(times)))
    log(f'f32 dense chi2_batch({BATCH}): f32 '
        + ' / '.join(f'{r:.1f}' for r in rates['f32']) + ' evals/s, f64 '
        + ' / '.join(f'{r:.1f}' for r in rates['f64']) + ' evals/s (turns '
        f'f64, f32, f32, f64, each the median of {TIMED_ROUNDS}); f32 / f64 '
        f'{np.median(rates["f32"]) / np.median(rates["f64"]):.3f}')
    for label, vega in (('f32', dense), ('f64', dense64)):
        profile_call(f'{label} dense chi2_batch({BATCH})',
                     lambda: vega.chi2_batch(batches).cpu(), device)
    del dense64

    # --- the grid collapse in f32 (dtype=): counts from zero
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid = VegaInterface(fit_ini, device=device, dtype=torch.float32)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        t0 = time.perf_counter()
        payload = grid.get_collapsed(frozenset(names))
        torch.cuda.synchronize(device)
        cold_s = time.perf_counter() - t0
        chi2 = grid.chi2_batch(draw_batch(BATCH)).cpu().numpy()
    launches['f32_grid'] = dict(LAUNCHES)
    f32_only('f32 grid', launches['f32_grid'])
    stats = grid.grid_stats
    log(f'f32 grid collapse: {payload["__grid__"]}, {stats["nodes"]} nodes, '
        f'cold {cold_s:.3f} s (device sweep {stats["sweep_s"]:.3f} s, host '
        f'{stats["host_s"]:.3f} s), kernel launches {launches["f32_grid"]}; '
        + '; '.join(f'{n}: T {p["cref"].shape[0]}, modes A '
                    f'{p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
                    f'rank {p["B_A"].shape[1]} / {p["B_sy"].shape[1]} '
                    f'(vega_tpu f32: {goldens["payload"][n]})'
                    for n, p in payload.items() if n != '__grid__'))
    if not np.all(np.isfinite(chi2)):
        fail('f32 grid chi2_batch is not finite')
    checks += check_launches(device, 'f32_grid', layouts)
    got = grid.chi2_batch(points).cpu().numpy()
    f32_ladder('f32 grid vs vega_tpu\'s f64 grid', got,
               goldens['chi2_grid_f64'])
    f32_ladder('f32 grid vs vega_tpu\'s f32 grid goldens', got,
               goldens['chi2_grid'], enforce=False)
    grid_rates = {}
    for n_rows in GRID_BATCHES:
        rows = draw_batch(n_rows)
        grid.chi2_batch(rows).cpu()
        per_round = []
        for _ in range(GRID_ROUNDS):
            for name in rows:
                rows[name] = rows[name] + 1e-6     # as bench.py
            t0 = time.perf_counter()
            grid.chi2_batch(rows).cpu()
            per_round.append(n_rows / (time.perf_counter() - t0))
        grid_rates[n_rows] = float(np.median(per_round))
        log(f'f32 grid chi2_batch({n_rows}): {grid_rates[n_rows]:.1f} '
            f'evals/s (median of {GRID_ROUNDS}; per round '
            f'{", ".join(f"{r:.1f}" for r in per_round)})')
    log(json.dumps({
        'metric': 'likelihood evals/sec/chip',
        'value': round(grid_rates[BATCH], 3),
        'unit': f'evals/s/chip (batch={BATCH}, f32, 1 chip(s), {card}, '
                f'vega_tpu_torch, collapse={cold_s:.1f}s; batch '
                f'{GRID_BATCHES[1]}: {grid_rates[GRID_BATCHES[1]]:.1f})'}))
    rows = draw_batch(BATCH)
    profile_call(f'f32 grid chi2_batch({BATCH})',
                 lambda: grid.chi2_batch(rows).cpu(), device)

    # --- the fits, dense then grid: counts from zero for each
    for regime, vega in (('dense', dense), ('grid', grid)):
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            timed_fit(device, vega, f'f32 {regime}')
        launches[f'f32_fit_{regime}'] = dict(LAUNCHES)
        checks += check_launches(device, f'f32_fit_{regime}', layouts)
        best, want = vega.bestfit, goldens[f'fit_{regime}']
        d_sigma = max(abs(best.values[n] - v) / e for n, v, e in
                      zip(names, want['values'], want['errors']))
        log(f'f32 {regime} fit: values {[best.values[n] for n in names]} '
            f'(vega_tpu f32 {want["values"]}), max |d value| / error '
            f'{d_sigma:.3e} (gate {F32_FIT_SIGMA:g}), fval '
            f'{best.fmin.fval!r} (vega_tpu f32 {want["fval"]!r}), valid '
            f'{best.fmin.is_valid}, kernel launches '
            f'{launches[f"f32_fit_{regime}"]}')
        if not (best.fmin.is_valid and d_sigma <= F32_FIT_SIGMA):
            fail(f'f32 {regime} fit is not valid or misses vega_tpu\'s f32 '
                 'fit')
    counts = launches['f32_fit_dense']
    f32_only('f32 dense fit', counts)
    if not (any(n for k, n in counts.items() if k[0] == 'Ft')
            and any(n for k, n in counts.items() if k[1] >= 1)):
        fail('the f32 dense fit launched no f32 Ft_d or no f32 kernel of '
             'order d >= 1')
    log(f'f32 phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


def run_scan_path(device, fit_ini):
    """The 40 x 40 (ap, at) profile scan on the fit phase's configuration
    (bias_LYA, beta_LYA re-minimised at each point) through
    batched_chi2_scan, served by the grid payload at its defaults:
    cold (with the payload build) and warm, every point in one fit chunk;
    then a 10 x 10 corner warm at vega_tpu's default chunk (8), held to
    the one-chunk scan within SCAN_CHUNK_FVAL_ABS in fval. Holds the 16 golden points of
    tests/data/torch_port_mc_goldens.json: |d fval| <= 2e-4 + 1e-9 |fval|,
    free values within FIT_VALUE_SIGMA['grid'] of the JAX errors there.
    Returns the launches of the scan's run and the kernel checks at its
    layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import batched_chi2_scan
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(MC_GOLDENS.read_text())['scan']
    lo, hi, n_axis = goldens['axis']
    axis = np.linspace(lo, hi, n_axis)
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        vega = VegaInterface(fit_ini, device=device)

    def scan(values, chunk, label):
        stats = {}
        with switch('VEGA_TPU_FIT_CHUNK_PER_DEVICE', str(chunk)):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            rows = batched_chi2_scan(vega, {'ap': values, 'at': values},
                                     stats=stats)
            torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        log(f'scan {label}: {len(rows)} points in chunks of {chunk}, '
            f'{seconds:.3f} s wall, Newton iterations per chunk '
            f'{stats["iterations"]}, host waiting in the stopping tests '
            f'{stats["sync_s"]:.3f} s, {stats["valid_rows"]} rows valid, '
            f'peak device memory {peak_gb:.3f} GB')
        return rows, stats

    # the scan's run: counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        rows, stats = scan(axis, n_axis ** 2,
                           f'{n_axis} x {n_axis} cold (with the payload)')
        payload_s = vega.grid_stats.get('total_s')
    launches = dict(LAUNCHES)
    log(f'scan payload build {payload_s:.3f} s; kernel launches {launches}')
    scan(axis, n_axis ** 2, f'{n_axis} x {n_axis} warm')
    corner = SCAN_DEFAULT_CHUNK_CORNER
    default_rows, default_stats = scan(
        axis[:corner], DEFAULT_FIT_CHUNK,
        f'{corner} x {corner} corner, default chunk')
    for label, run, n_rows in (('one chunk', stats, len(rows)),
                               ('default chunk', default_stats,
                                len(default_rows))):
        if run['valid_rows'] != n_rows:
            fail(f'{n_rows - run["valid_rows"]} scan rows are not valid '
                 f'({label})')
    corner_rows = [rows[i * n_axis + j] for i in range(corner)
                   for j in range(corner)]
    d_default = max(abs(a['fval'] - b['fval'])
                    for a, b in zip(corner_rows, default_rows))
    log(f'scan default chunk vs one chunk: max |d fval| {d_default:.3e} '
        f'(bound {SCAN_CHUNK_FVAL_ABS:g})')
    if not d_default <= SCAN_CHUNK_FVAL_ABS:
        fail(f'the scan in chunks of {DEFAULT_FIT_CHUNK} differs from the '
             f'scan in one chunk by {d_default:.3e} in fval')
    points = torch.tensor([[r['ap'], r['at']] for r in rows],
                          dtype=torch.float64, device=device)
    start = torch.tensor([[-0.12, 1.6]] * len(rows), dtype=torch.float64,
                         device=device)
    profile_call(f'scan derivatives ({len(rows)} rows, one Newton '
                 'iteration)', lambda: vega.chi2_batch_derivatives(
                     goldens['free'], start,
                     fixed={'ap': points[:, 0], 'at': points[:, 1]}),
                 device)
    if not all(np.isfinite(r['fval']) and r['fval'] < 1e100 for r in rows):
        fail('a scan point is not finite or took the penalty')

    d_fval = d_sigma = 0.0
    for want in goldens['rows']:
        i = int(np.argmin(np.abs(axis - want['ap'])))
        j = int(np.argmin(np.abs(axis - want['at'])))
        got = rows[i * n_axis + j]
        if (got['ap'], got['at']) != (want['ap'], want['at']):
            fail(f'scan point {(got["ap"], got["at"])} is not the golden '
                 f'{(want["ap"], want["at"])}')
        bound = GRID_ABS_TOL + GRID_REL_TOL * abs(want['fval'])
        d_fval = max(d_fval, abs(got['fval'] - want['fval']) / bound)
        for name in goldens['free']:
            d_sigma = max(d_sigma, abs(got[name] - want[name])
                          / want['errors'][name])
    log(f'scan vs JAX goldens ({len(goldens["rows"])} points): max |d fval| '
        f'{d_fval:.3e} of its bound, max |d value| / error {d_sigma:.3e} '
        f'(bound {FIT_VALUE_SIGMA["grid"]:g})')
    if not d_fval <= 1.0:
        fail('scan fval vs the JAX goldens over the bound')
    if not d_sigma <= FIT_VALUE_SIGMA['grid']:
        fail(f'scan values differ from the JAX scan by {d_sigma:.3e} errors')
    return launches, check_launches(device, 'scan', layouts)


def numpy_mocks(vega, fiducial, n_mocks, seed):
    """The goldens tool's mocks: fid_masked + z @ L.T per correlation, z
    from np.random.default_rng(seed) in corr_items order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, data in vega.data.items():
        mask = data.data_mask
        chol = np.linalg.cholesky(data.cov_mat[np.ix_(mask, mask)])
        z = rng.standard_normal((n_mocks, int(mask.sum())))
        out[name] = np.asarray(fiducial[name])[mask] + z @ chol.T
    return out


def check_mock_fits(label, got, want):
    """Fits of the golden mocks against the JAX package's."""
    d_sigma = float(np.max(np.abs(got['values'] - np.asarray(want['values']))
                           / np.asarray(want['errors'])))
    d_err = float(np.max(np.abs(got['errors'] / np.asarray(want['errors'])
                                - 1)))
    d_chi2 = float(np.max(np.abs(got['chisq'] - np.asarray(want['chisq']))))
    log(f'{label} vs JAX goldens ({len(want["chisq"])} mocks): max |d value|'
        f' / error {d_sigma:.3e}, errors max relative diff {d_err:.3e}, '
        f'max |d chi2| {d_chi2:.3e}, valid {got["valid"].tolist()}')
    if not d_sigma <= MC_VALUE_SIGMA:
        fail(f'{label}: values differ by {d_sigma:.3e} errors')
    if not d_err <= MC_ERROR_RTOL:
        fail(f'{label}: errors differ by {d_err:.3e} relative')
    if not d_chi2 <= MC_CHI2_ABS:
        fail(f'{label}: chi2 differs by {d_chi2:.3e}')
    if got['valid'].tolist() != list(want['valid']):
        fail(f'{label}: valid {got["valid"].tolist()}, JAX {want["valid"]}')


def timed_mock_fits(device, engine, mocks, sample, chunk, label, **kwargs):
    """fit_mocks in chunks of `chunk` rows, synchronised; logs the wall
    time, s per fit, Newton iterations, share valid and peak memory."""
    stats = {}
    n_mocks = len(next(iter(mocks.values())))
    with switch('VEGA_TPU_FIT_CHUNK_PER_DEVICE', str(chunk)):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        fits = engine.fit_mocks(mocks, sample, stats=stats, **kwargs)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    log(f'{label}: {n_mocks} mocks in chunks of {chunk}, {seconds:.3f} s '
        f'wall, {seconds / n_mocks:.4f} s per fit, Newton iterations per '
        f'chunk {stats["iterations"]}, host waiting in the stopping tests '
        f'{stats["sync_s"]:.3f} s, valid {float(np.mean(fits["valid"])):.4f}'
        f', peak device memory '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB')
    return fits


def run_mc_path(device, work):
    """Monte-Carlo campaigns on the fit configuration with [monte carlo]
    and [mc parameters] (the goldens' MC_CONTROL): mocks from
    MonteCarloEngine.generate_mocks around the fiducial at [mc
    parameters], fitted with fit_mocks.

    (a) dense: (ap, at, bias_LYA, beta_LYA), MC_DENSE_MOCKS mocks at the
    default chunk and in one chunk, then MC_DENSE_PROBE_MOCKS in one
    chunk; the goldens' numpy mocks against the JAX fits, with the
    kernels and with the plain combine (derivatives at the start 1e-10 /
    1e-9 relative). Fails unless it launched the transpose and a kernel
    of order d >= 1 at a layout with B > 1.
    (b) collapse: (bias_LYA, beta_LYA) through the nuisance collapse
    without data terms, MC_COLLAPSE_MOCKS mocks in one chunk; its golden
    mocks the same way.

    Returns the launches of each campaign's run and the kernel checks at
    their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import MonteCarloEngine
    from vega_tpu_torch.testing import make_synthetic_dataset
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(MC_GOLDENS.read_text())
    t0 = time.perf_counter()
    mc_ini = make_synthetic_dataset(Path(work) / 'mc', cross=True,
                                    size='full', device=device,
                                    sample=goldens['sample'],
                                    extra_control=goldens['mc_control'])
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        vega = VegaInterface(mc_ini, device=device)
    fiducial = vega.compute_model(vega.mc_config['params'], run_init=False)
    engine = MonteCarloEngine(vega)
    log(f'mc: configuration and fiducial at {vega.mc_config["params"]} in '
        f'{time.perf_counter() - t0:.2f} s')

    def sample_for(names):
        return {key: {n: vega.mc_config['sample'][key][n] for n in names}
                for key in ('limits', 'values', 'errors', 'fix')}

    launches, checks = {}, []
    for kind, n_mocks in (('dense', MC_DENSE_MOCKS),
                          ('collapse', MC_COLLAPSE_MOCKS)):
        want = goldens['mc'][kind]
        sample = sample_for(want['names'])
        golden_mocks = numpy_mocks(vega, fiducial, want['n_mocks'],
                                   want['seed'])
        # the campaign's run: counts from zero
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            campaigns = ([(n_mocks, DEFAULT_FIT_CHUNK), (n_mocks, n_mocks),
                          (MC_DENSE_PROBE_MOCKS, MC_DENSE_PROBE_MOCKS)]
                         if kind == 'dense' else [(n_mocks, n_mocks)])
            for count, chunk in campaigns:
                mocks = engine.generate_mocks(fiducial, count, seed=MC_SEED)
                fits = timed_mock_fits(device, engine, mocks, sample, chunk,
                                       f'mc {kind}')
                if not np.mean(fits['valid']) >= 0.9:
                    fail(f'mc {kind}: only {np.mean(fits["valid"]):.3f} of '
                         'the fits are valid')
            got = timed_mock_fits(device, engine, golden_mocks, sample,
                                  DEFAULT_FIT_CHUNK, f'mc {kind} golden')
            check_mock_fits(f'mc {kind}', got, want)
        launches[f'mc_{kind}'] = dict(LAUNCHES)
        log(f'mc {kind} kernel launches: {launches[f"mc_{kind}"]}')
        checks += check_launches(device, f'mc_{kind}', layouts)
        if kind != 'dense':
            continue
        plain = timed_mock_fits(device, engine, golden_mocks, sample,
                                DEFAULT_FIT_CHUNK, 'mc dense golden, plain '
                                'combine', use_kernel=False)
        check_mock_fits('mc dense golden, plain combine', plain, want)
        x0 = torch.tensor([[vega.mc_config['sample']['values'][n]
                            for n in want['names']]] * want['n_mocks'],
                          dtype=torch.float64, device=device)
        data = {k: torch.as_tensor(v, device=device)
                for k, v in golden_mocks.items()}
        routes = [vega.chi2_batch_derivatives(
            want['names'], x0, data_vecs=data,
            cov_scales=dict.fromkeys(data, 1.0), use_kernel=use_kernel)
            for use_kernel in (True, False)]
        compare_derivatives(
            'mc dense at the start, kernels vs plain combine',
            *({'chi2': list(r[0].cpu().numpy()),
               'gradient': list(r[1].cpu().numpy()),
               'hessian': list(r[2].cpu().numpy())} for r in routes),
            {'chi2': KERNEL_GRAD_RTOL, 'gradient': KERNEL_GRAD_RTOL,
             'hessian': KERNEL_HESS_RTOL})
        for rows in (DEFAULT_FIT_CHUNK, MC_DENSE_MOCKS):
            profile_call(f'mc dense derivatives ({rows} rows, one Newton '
                         'iteration)', lambda: vega.chi2_batch_derivatives(
                             want['names'], x0[:1].expand(rows, -1),
                             data_vecs={k: v[:rows]
                                        for k, v in mocks.items()},
                             cov_scales=dict.fromkeys(data, 1.0)), device)
        batched = [key for key in layouts if key[2] > 1]
        if not any(key[0] == 'Ft' for key in batched):
            fail('the dense mock fits launched no transpose kernel (Ft_d) '
                 'at B > 1')
        if not any(key[1] >= 1 for key in batched):
            fail('the dense mock fits launched no kernel of order d >= 1 '
                 'at B > 1')
    return launches, checks


# ----------------------------------------------------------------------
# The sampler phase
# ----------------------------------------------------------------------
def weighted_moments(samples, weights):
    mean = np.average(samples, axis=0, weights=weights)
    return mean, np.sqrt(np.average((samples - mean) ** 2, axis=0,
                                    weights=weights))


def sampler_ini(fit_ini, out_dir, name, settings):
    """The fit configuration with `run_sampler`, `sampler = name` and the
    sampler's section, as a user would write it; returns its path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    text = Path(fit_ini).read_text().replace(
        '[control]\n', f'[control]\nrun_sampler = True\nsampler = {name}\n')
    text += f'\n[{name}]\npath = {out_dir}\nname = chain\n' + ''.join(
        f'{key} = {value}\n' for key, value in settings.items())
    path = Path(fit_ini).parent / f'main_{out_dir.name}.ini'
    path.write_text(text)
    return path


@contextlib.contextmanager
def timed_method(cls, name, device, times):
    """While open, every call of cls.name is timed (synchronised) into
    `times`."""
    original = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = original(self, *args, **kwargs)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        return out

    setattr(cls, name, wrapper)
    try:
        yield
    finally:
        setattr(cls, name, original)


def run_sampler_script(device, ini, label, sampler_class):
    """scripts/run_vega_sampler.py on `ini`: (interface, sampler, results,
    the s of sampler_class.run alone)."""
    from vega_tpu_torch.scripts import run_vega_sampler
    run_s = []
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with timed_method(sampler_class, 'run', device, run_s):
        vega, sampler, results = run_vega_sampler.run(
            [str(ini), '--device', str(device)])
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if type(sampler) is not sampler_class or len(run_s) != 1:
        fail(f'{label}: the script did not run {sampler_class.__name__}')
    log(f'{label}: run_vega_sampler {seconds:.3f} s wall, of which the '
        f'sampler\'s run {run_s[0]:.3f} s (with the payload build at its '
        f'first likelihood call; the rest is the interface); peak device '
        f'memory {peak_gb:.3f} GB')
    return vega, sampler, results, run_s[0]


def read_stats(out_dir):
    return dict(line.split(' = ') for line in
                (out_dir / 'chain.stats').read_text().splitlines())


def check_chain(label, vega, out_dir, names, limits, logl_column=True):
    """The written chain: finite, inside the limits, and its -2 ln L
    column equal to -2 log_lik_batch at its points (SAMPLER_LOGL_RTOL;
    not for HMC, whose column is twice the potential, log-Jacobian
    included). Returns the chain."""
    chain = np.loadtxt(out_dir / 'chain.txt')
    if chain.shape[1] != 2 + len(names) or not np.all(np.isfinite(chain)):
        fail(f'{label}: the chain is not finite with {2 + len(names)} '
             'columns')
    lo = np.array([limits[n][0] for n in names])
    hi = np.array([limits[n][1] for n in names])
    if not np.all((chain[:, 2:] >= lo) & (chain[:, 2:] <= hi)):
        fail(f'{label}: a chain point lies outside the prior limits')
    if not logl_column:
        log(f'{label}: chain {chain.shape[0]} x {chain.shape[1]}, finite, '
            'inside the limits')
        return chain
    want = -2.0 * vega.log_lik_batch(
        {n: chain[:, 2 + i] for i, n in enumerate(names)}).cpu().numpy()
    rel = float(np.max(np.abs(chain[:, 1] - want) / np.abs(want)))
    log(f'{label}: chain {chain.shape[0]} x {chain.shape[1]}, finite, '
        f'inside the limits; -2 ln L column vs -2 log_lik_batch: max '
        f'relative diff {rel:.3e} (bound {SAMPLER_LOGL_RTOL:g})')
    if not rel <= SAMPLER_LOGL_RTOL:
        fail(f'{label}: the chain\'s -2 ln L differs from log_lik_batch by '
             f'{rel:.3e}')
    return chain


def check_moments(label, names, mean, std, fit, mean_sigma, std_rtol):
    """Posterior mean within mean_sigma of the fit goldens' errors of
    their grid best fit, posterior sigma within std_rtol of those
    errors."""
    d_mean = np.abs(mean - np.asarray(fit['values'])) / np.asarray(
        fit['errors'])
    d_std = np.abs(std / np.asarray(fit['errors']) - 1)
    log(f'{label}: posterior mean {mean.tolist()}, sigma {std.tolist()}; '
        f'|mean - best fit| / error {d_mean.tolist()} (bound '
        f'{mean_sigma:g}), |sigma / error - 1| {d_std.tolist()} (bound '
        f'{std_rtol:g}) for {names}')
    if not np.all(d_mean <= mean_sigma):
        fail(f'{label}: posterior mean off the best fit by '
             f'{d_mean.max():.3f} errors')
    if not np.all(d_std <= std_rtol):
        fail(f'{label}: posterior sigma off the fit errors by '
             f'{d_std.max():.3f}')


def time_chi2_batch(device, vega, n_rows):
    """evals/s of chi2_batch at n_rows drawn rows, the result fetched:
    median of GRID_ROUNDS rounds after a warm call."""
    rows = draw_batch(n_rows)
    vega.chi2_batch(rows).cpu()
    rates = []
    for _ in range(GRID_ROUNDS):
        for name in rows:
            rows[name] = rows[name] + 1e-6
        t0 = time.perf_counter()
        vega.chi2_batch(rows).cpu()
        rates.append(n_rows / (time.perf_counter() - t0))
    return float(np.median(rates))


def compare_evolutions(device, label, evolve, start, l_min, width, chol,
                       replays, eager_runs):
    """One evolution on the same inputs and random numbers, replayed from
    the CUDA graph and run eagerly: logl within EVOLVE_LOGL_RTOL, u and
    the counts equal (an accept test within round-off of l_min could part
    the two; the message says so if it happens). Returns the median
    seconds of a replay and of an eager run."""
    evolve.load(start, l_min, width, chol)
    evolve.draw(1_000_000)
    n_u = evolve.n * evolve.ndim
    outs, seconds = {}, {}
    for graph, count in ((True, replays), (False, eager_runs)):
        times = []
        for _ in range(count):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = evolve.run(graph)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        outs[graph] = out.clone().cpu().numpy()
        seconds[graph] = float(np.median(times))
    d_logl = float(np.max(np.abs(
        outs[True][n_u:-2] - outs[False][n_u:-2])
        / np.abs(outs[False][n_u:-2])))
    same_u = np.array_equal(outs[True][:n_u], outs[False][:n_u])
    same_counts = np.array_equal(outs[True][-2:], outs[False][-2:])
    log(f'{label}: replayed vs eager evolution on the same inputs: logl max '
        f'relative diff {d_logl:.3e} (bound {EVOLVE_LOGL_RTOL:g}), u '
        f'{"equal" if same_u else "DIFFERENT"}, steps and moves '
        f'{outs[True][-2:].tolist()} vs {outs[False][-2:].tolist()}; s per '
        f'evolution replayed {seconds[True]:.4f} (median of {replays}), '
        f'eager {seconds[False]:.4f} (median of {eager_runs}), x'
        f'{seconds[False] / seconds[True]:.2f}')
    if not (d_logl <= EVOLVE_LOGL_RTOL and same_u and same_counts):
        fail(f'{label}: the replayed evolution differs from the eager one '
             '(unless an accept test sat within round-off of l_min)')
    return seconds[True], seconds[False]


def run_ns_paths(device, fit_ini, out, goldens, fit_goldens):
    """Phases 1 and 2: the nested sampler with its device loop (one CUDA
    graph replay per iteration) on the grid payload, held to the JAX
    goldens; then the host loop for a few iterations."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES, REPLAYED,
                                                   recorded_launches)
    from vega_tpu_torch.samplers.nested import NestedSampler

    names = goldens['names']
    settings = goldens['settings']
    ini = sampler_ini(fit_ini, out / 'ns_device', 'NestedJax', settings)
    evolve_s = []
    # the NS path's run: counts from zero
    LAUNCHES.clear()
    REPLAYED.clear()
    with recorded_launches() as layouts, timed_method(
            NestedSampler, '_slice_evolve_device', device, evolve_s):
        vega, sampler, result, seconds = run_sampler_script(
            device, ini, 'NS device loop', NestedSampler)
    launches, replays = dict(LAUNCHES), dict(REPLAYED)
    if not launches.get(('F', 0)):
        fail('the NS run launched no spline_legendre_combine kernel (the '
             'payload sweep)')
    evolve = sampler._evolve_fn
    if evolve is None or evolve.graph is None:
        fail('the NS device loop did not run as a CUDA graph')
    stats = read_stats(out / 'ns_device')
    iterations = int(stats['num_iterations'])
    evals = int(stats['num_like_evals'])
    n = evolve.n
    per_iteration = n * (1 + sampler.num_repeats * sampler.max_shrink)
    if evals != sampler.num_live + iterations * per_iteration:
        fail(f'num_like_evals {evals} is not num_live + iterations x '
             f'{per_iteration}')
    # the first call holds the capture (warm-up run, capture,
    # instantiation)
    replay_s = float(np.median(evolve_s[1:]))
    log(f'NS device loop: settings {settings}; {iterations} iterations, '
        f'{evals} likelihood rows, logZ = {result["logz"]:.4f} +/- '
        f'{result["logz_err"]:.4f} (JAX host loop '
        f'{goldens["nested"]["logz"]:.4f} +/- '
        f'{goldens["nested"]["logz_err"]:.4f}, '
        f'{goldens["nested"]["iterations"]} iterations); first iteration '
        f'with the graph\'s capture {evolve_s[0]:.3f} s, then '
        f'{replay_s:.4f} s per iteration (median; load, draw, replay, '
        f'fetch), {sum(evolve_s):.3f} s of {seconds:.3f} s in the '
        f'evolutions; {per_iteration / replay_s:.1f} evals/s inside the '
        f'sampler ({n} chains x {per_iteration // n} dependent calls per '
        f'iteration); kernel launches {launches}, of them from graph '
        f'replays {replays}')
    rates = {rows: time_chi2_batch(device, vega, rows)
             for rows in (n, BATCH)}
    log(f'NS device loop: chi2_batch({n}) {rates[n]:.1f} evals/s, '
        f'chi2_batch({BATCH}) {rates[BATCH]:.1f} evals/s (median of '
        f'{GRID_ROUNDS}, result fetched)')

    limits = vega.sample_params['limits']
    check_chain('NS device loop', vega, out / 'ns_device', names, limits)
    mean, std = weighted_moments(result['samples'], result['weights'])
    check_moments('NS device loop', names, mean, std,
                  fit_goldens['fit_grid'], NS_MEAN_SIGMA, NS_STD_RTOL)
    want = goldens['nested']
    bound = 3.0 * max(result['logz_err'], want['logz_err'], 0.1)
    if not abs(result['logz'] - want['logz']) <= bound:
        fail(f'NS logZ {result["logz"]:.4f} is not within {bound:.3f} of '
             f'the JAX package\'s {want["logz"]:.4f}')

    live_logl = sampler._batch_log_lik(
        sampler.prior_transform(sampler.live_u))
    chol = np.linalg.cholesky(np.cov(sampler.live_u, rowvar=False)
                              + 1e-12 * np.eye(len(names)))
    replayed_s, eager_s = compare_evolutions(
        device, 'NS device loop', evolve, sampler.live_u[:n],
        float(np.percentile(live_logl, 25)), 2.0, chol, 5, 1)
    log(f'NS device loop: {per_iteration / replayed_s:.1f} evals/s '
        f'replayed, {per_iteration / eager_s:.1f} eager')
    profile_call('NS evolution, replayed (one iteration)',
                 lambda: evolve.run(True), device)
    checks = check_launches(device, 'ns', layouts)

    ini = sampler_ini(fit_ini, out / 'ns_host', 'NestedJax',
                      {**settings, 'device_loop': False,
                       'max_iters': NS_HOST_ITERATIONS})
    host_s = []
    with timed_method(NestedSampler, '_slice_evolve', device, host_s):
        _, host_sampler, _, _ = run_sampler_script(
            device, ini, 'NS host loop', NestedSampler)
    calls = (host_sampler._n_evals - host_sampler.num_live) / n
    log(f'NS host loop (device_loop = False), {len(host_s)} iterations: s '
        f'per iteration {", ".join(f"{t:.4f}" for t in host_s)} (median '
        f'{np.median(host_s):.4f}), {calls / len(host_s):.1f} batched '
        f'likelihood calls of {n} rows per iteration, '
        f'{calls * n / sum(host_s):.1f} evals/s')
    if host_sampler._evolve_fn is not None or len(host_s) != \
            NS_HOST_ITERATIONS:
        fail('device_loop = False did not run the host loop')
    return {'ns': launches}, {'ns': replays}, checks


def run_smc_path(device, fit_ini, out, goldens, fit_goldens):
    """Phase 3: a [PocoMC] section, routed to the native SMC sampler."""
    from vega_tpu_torch.samplers.smc import SMCSampler
    names = goldens['names']
    ini = sampler_ini(fit_ini, out / 'smc', 'PocoMC',
                      {**SMC_SETTINGS, 'resume': False})
    vega, sampler, result, seconds = run_sampler_script(device, ini, 'SMC',
                                                        SMCSampler)
    stats = read_stats(out / 'smc')
    stages = int(stats['num_stages'])
    n = sampler.n_particles
    evals = n * (1 + stages * sampler.n_mcmc)
    log(f'SMC: settings {SMC_SETTINGS}; {stages} stages, logZ = '
        f'{result["logz"]:.4f}, {evals} likelihood rows in calls of {n}, '
        f'{seconds:.3f} s, {evals / seconds:.1f} evals/s over the run '
        '(payload included)')
    check_chain('SMC', vega, out / 'smc', names,
                vega.sample_params['limits'])
    mean, std = weighted_moments(result['samples'], result['weights'])
    check_moments('SMC', names, mean, std, fit_goldens['fit_grid'],
                  2 * NS_MEAN_SIGMA, 2 * NS_STD_RTOL)
    if not np.isfinite(result['logz']):
        fail('SMC logZ is not finite')


def hmc_trajectory_times(device, label, sampler, result):
    """One trajectory at the run's last positions, step size and metric:
    eager and as a CUDA graph, on the same momenta and uniforms (u within
    1e-12); a torch.profiler breakdown of the eager one. Returns
    (graph s, eager s)."""
    from vega_tpu_torch.samplers.hmc import GraphedStep, make_hmc_step

    chains, ndim = sampler.num_chains, sampler.num_params
    lo = np.array([sampler.limits[n][0] for n in sampler.names])
    hi = np.array([sampler.limits[n][1] for n in sampler.names])
    unit = (result['samples'][-chains:] - lo) / (hi - lo)

    def tensor(values):
        return torch.as_tensor(np.asarray(values, dtype=np.float64),
                               device=device)

    with torch.no_grad():
        u = tensor(np.log(unit / (1 - unit)))
        pot_vg = sampler._build_potential()
        v, g = pot_vg(u)
        eps = tensor(result['step_size'])
        inv_mass = tensor(result['inv_mass'])
        chol_mass = tensor(np.linalg.cholesky(np.linalg.inv(
            result['inv_mass'])))
        generator = torch.Generator(device=device).manual_seed(1)
        z = torch.randn((chains, ndim), generator=generator,
                        dtype=torch.float64, device=device)
        log_unif = torch.log(torch.rand(chains, generator=generator,
                                        dtype=torch.float64, device=device))
        args = (z, log_unif, u, v, g, eps, inv_mass, chol_mass)
        eager = make_hmc_step(pot_vg, sampler.num_leapfrog)
        t0 = time.perf_counter()
        graphed = GraphedStep(eager, (u, v, g), eps, inv_mass, chol_mass)
        torch.cuda.synchronize(device)
        capture_s = time.perf_counter() - t0
        seconds, outs = {}, {}
        for kind, step, count in (('graph', graphed, 10),
                                  ('eager', eager, 3)):
            step(*args)
            times = []
            for _ in range(count):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize(device)
                times.append(time.perf_counter() - t0)
            outs[kind] = [t.clone() for t in out]
            seconds[kind] = float(np.median(times))
        d_u = float((outs['graph'][0] - outs['eager'][0]).abs().max())
        calls = sampler.num_leapfrog
        log(f'{label}: one trajectory of {calls} leapfrog steps for '
            f'{chains} chains at step {result["step_size"]:.4g}: replayed '
            f'{seconds["graph"]:.4f} s ({calls / seconds["graph"]:.1f} '
            f'gradient calls/s), eager {seconds["eager"]:.4f} s '
            f'({calls / seconds["eager"]:.1f}), x'
            f'{seconds["eager"] / seconds["graph"]:.2f}; capture '
            f'{capture_s:.3f} s; max |u replayed - u eager| {d_u:.3e}')
        if not d_u <= 1e-12:
            fail(f'{label}: the replayed trajectory differs from the eager '
                 f'one by {d_u:.3e}')
        profile_call(f'{label} trajectory, eager', lambda: eager(*args),
                     device)
        profile_call(f'{label} trajectory, replayed',
                     lambda: graphed(*args), device)
    return seconds['graph'], seconds['eager']


HOOK_LIMITS = {'a': (-2.0, 3.0), 'b': (0.0, 4.0), 'c': (-1.0, 1.0)}
HOOK_MEAN = (0.4, 1.7, -0.2)
HOOK_SIGMA = (0.5, 0.4, 0.3)
HOOK_SETTINGS = {'num_chains': 32, 'num_warmup': 200, 'num_samples': 300,
                 'num_leapfrog': 8, 'seed': 1}


def run_hmc_hook(device, out):
    """HMC's standalone hook on the card: a plain torch chi^2 (an
    uncorrelated Gaussian inside a box) with no device argument, its
    trajectory captured as a CUDA graph like the interface's. Mean within
    0.2 sigma of the truth, sigma within 15%, acceptance in (0.5, 1],
    split-R-hat < 1.1."""
    import configparser
    from vega_tpu_torch.samplers.hmc import HMC, GraphedStep

    mean = torch.tensor(HOOK_MEAN, dtype=torch.float64, device=device)
    sigma = torch.tensor(HOOK_SIGMA, dtype=torch.float64, device=device)

    def chi2(x):
        return torch.sum(((x - mean) / sigma) ** 2, dim=-1)

    path = Path(out) / 'hmc_hook'
    path.mkdir(parents=True, exist_ok=True)
    config = configparser.ConfigParser()
    config['HMC'] = {'path': str(path), 'name': 'hook',
                     **{k: str(v) for k, v in HOOK_SETTINGS.items()}}
    t0 = time.perf_counter()
    sampler = HMC(config['HMC'], HOOK_LIMITS, chi2)
    result = sampler.run()
    seconds = time.perf_counter() - t0
    if sampler.device.type != 'cuda' or not isinstance(sampler._step,
                                                        GraphedStep):
        fail('the HMC hook did not run its trajectory as a CUDA graph on '
             'the card')
    got_mean = result['samples'].mean(axis=0)
    got_sigma = result['samples'].std(axis=0)
    d_mean = np.abs(got_mean - np.array(HOOK_MEAN)) / np.array(HOOK_SIGMA)
    d_sigma = np.abs(got_sigma / np.array(HOOK_SIGMA) - 1)
    log(f'HMC hook (plain torch chi^2 on {sampler.device}): settings '
        f'{HOOK_SETTINGS}; {seconds:.3f} s, acceptance '
        f'{result["accept_rate"]:.3f}, split-R-hat '
        f'{result["r_hat"].tolist()}, |mean - truth| / sigma '
        f'{d_mean.tolist()} (bound 0.2), |sigma / truth - 1| '
        f'{d_sigma.tolist()} (bound 0.15)')
    if not (0.5 < result['accept_rate'] <= 1.0
            and np.max(result['r_hat']) < 1.1 and np.all(d_mean <= 0.2)
            and np.all(d_sigma <= 0.15)):
        fail('the HMC hook\'s run on the card missed its bounds')


def run_hmc_paths(device, fit_ini, out, goldens, fit_goldens):
    """Phases 4 and 5: HMC on the grid payload, then a short run in the
    dense regime (VEGA_TPU_FACTORED=0), where each gradient call runs the
    combine's forward and first backward kernels at B = num_chains; the
    dense log-likelihood's evolution as a CUDA graph beside them."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES, REPLAYED,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import BatchedLikelihood
    from vega_tpu_torch.samplers.hmc import HMC
    from vega_tpu_torch.samplers.nested import DeviceEvolve

    names = goldens['names']
    launches, replays, checks = {}, {}, []
    ini = sampler_ini(fit_ini, out / 'hmc_grid', 'HMC', HMC_GRID_SETTINGS)
    LAUNCHES.clear()
    REPLAYED.clear()
    with recorded_launches() as layouts:
        vega, sampler, result, seconds = run_sampler_script(
            device, ini, 'HMC grid', HMC)
    launches['hmc_grid'] = dict(LAUNCHES)
    replays['hmc_grid'] = dict(REPLAYED)
    if not launches['hmc_grid'].get(('F', 0)):
        fail('the HMC grid run launched no spline_legendre_combine kernel '
             '(the payload sweep)')
    trajectories = (sum(max(5, max(sampler.num_warmup, 20) // d)
                        for d in (4, 2, 4)) + sampler.num_samples)
    log(f'HMC grid: settings {HMC_GRID_SETTINGS}; {trajectories} '
        f'trajectories in {seconds:.3f} s ({seconds / trajectories:.4f} s '
        f'per trajectory, payload and capture included), acceptance {result["accept_rate"]:.3f}, step '
        f'{result["step_size"]:.4g}, split-R-hat '
        f'{result["r_hat"].tolist()}, ESS {result["ess"].tolist()}; '
        f'kernel launches {launches["hmc_grid"]}, of them from graph '
        f'replays {replays["hmc_grid"]}')
    if not 0.5 < result['accept_rate'] <= 1.0:
        fail(f'HMC grid acceptance {result["accept_rate"]:.3f} outside '
             '(0.5, 1]')
    if not np.max(result['r_hat']) < 1.1:
        fail(f'HMC grid max split-R-hat {np.max(result["r_hat"]):.3f} '
             '>= 1.1')
    check_chain('HMC grid', vega, out / 'hmc_grid', names,
                vega.sample_params['limits'], logl_column=False)
    mean, std = weighted_moments(result['samples'],
                                 np.ones(len(result['samples'])))
    check_moments('HMC grid', names, mean, std, fit_goldens['fit_grid'],
                  2 * NS_MEAN_SIGMA, 2 * NS_STD_RTOL)
    hmc_trajectory_times(device, 'HMC grid', sampler, result)
    checks += check_launches(device, 'hmc_grid', layouts)

    ini = sampler_ini(fit_ini, out / 'hmc_dense', 'HMC', HMC_DENSE_SETTINGS)
    LAUNCHES.clear()
    REPLAYED.clear()
    with recorded_launches() as layouts, switch('VEGA_TPU_FACTORED', '0'):
        vega, sampler, result, seconds = run_sampler_script(
            device, ini, 'HMC dense', HMC)
    launches['hmc_dense'] = dict(LAUNCHES)
    replays['hmc_dense'] = dict(REPLAYED)
    chains = sampler.num_chains
    log(f'HMC dense: settings {HMC_DENSE_SETTINGS}; run {seconds:.3f} s; '
        f'acceptance '
        f'{result["accept_rate"]:.3f}, step {result["step_size"]:.4g}; '
        f'kernel launches {launches["hmc_dense"]}, of them from graph '
        f'replays {replays["hmc_dense"]} (the rest eager: the start, the '
        'warm-up runs before the capture)')
    if not replays['hmc_dense'].get(('Ft', 0)):
        fail('the dense HMC run replayed no captured Ft_0 launch')
    at_chains = [key for key in layouts if key[2] == chains]
    for wanted, found in (
            ('F_d with d >= 1', any(k[0] == 'F' and k[1] >= 1
                                    for k in at_chains)),
            ('P_d', any(k[0] == 'P' for k in at_chains)),
            ('Ft_d', any(k[0] == 'Ft' for k in at_chains))):
        if not found:
            fail(f'the dense HMC run launched no {wanted} at B = {chains}')
    if not np.all(np.isfinite(result['samples'])):
        fail('the dense HMC chain is not finite')
    x = torch.as_tensor(result['samples'][-chains:], device=device)
    routes = [vega.chi2_batch_derivatives(names, x, use_kernel=use_kernel,
                                          hessian=False)
              for use_kernel in (True, False)]
    compare_derivatives(
        'HMC dense at the last positions, kernels vs plain combine',
        *({'chi2': list(r[0].cpu().numpy()),
           'gradient': list(r[1].cpu().numpy())} for r in routes),
        {'chi2': KERNEL_GRAD_RTOL, 'gradient': KERNEL_GRAD_RTOL})
    hmc_trajectory_times(device, 'HMC dense', sampler, result)
    checks += check_launches(device, 'hmc_dense', layouts)

    # the dense log-likelihood inside a CUDA graph: the combine's
    # launches are captured, count at each replay, and give the eager
    # evolution's result
    LAUNCHES.clear()
    REPLAYED.clear()
    with recorded_launches() as layouts:
        evolve = DeviceEvolve(BatchedLikelihood(vega), names,
                              vega.sample_params['limits'], *NS_DENSE_SHAPE,
                              seed=0)
        captured = len(evolve.graph.launches)
        if LAUNCHES[('F', 0)] == 0 or not captured:
            fail('the dense evolution captured no combine launch')
        lo = np.array([vega.sample_params['limits'][n][0] for n in names])
        hi = np.array([vega.sample_params['limits'][n][1] for n in names])
        start = (result['samples'][-NS_DENSE_SHAPE[0]:] - lo) / (hi - lo)
        l_min = float(np.median(vega.log_lik_batch(dict(zip(
            names, result['samples'][-NS_DENSE_SHAPE[0]:].T))).cpu()
            .numpy()))
        before = LAUNCHES[('F', 0)]
        compare_evolutions(device, 'NS dense evolution', evolve, start,
                           l_min, 2.0, 1e-4 * np.eye(len(names)), 3, 2)
    moved = LAUNCHES[('F', 0)] - before
    replayed = REPLAYED[('F', 0)]
    log(f'NS dense evolution ({NS_DENSE_SHAPE[0]} chains, '
        f'{NS_DENSE_SHAPE[1]} repeats x {NS_DENSE_SHAPE[2]} shrink steps): '
        f'{captured} combine launches in the graph, F_0 count moved by '
        f'{moved} over 3 replays and 2 eager runs, {replayed} of it from '
        'the replays')
    if moved != 5 * captured or replayed != 3 * captured:
        fail(f'F_0 count moved by {moved} ({replayed} from replays), not '
             f'5 x {captured} (3 x {captured}): a replay does not count '
             'its launches as an eager run does')
    launches['ns_dense'] = dict(LAUNCHES)
    replays['ns_dense'] = dict(REPLAYED)
    checks += check_launches(device, 'ns_dense', layouts)
    run_hmc_hook(device, out)
    return launches, replays, checks


def run_sampler_paths(device, work, fit_ini):
    """The sampler phase: NS (device loop, host loop), SMC and HMC on the
    fit configuration through scripts/run_vega_sampler.py. Returns the
    kernel launches of each path's run and the kernel checks at their
    layouts."""
    goldens = json.loads(SAMPLER_GOLDENS.read_text())
    fit_goldens = json.loads(FIT_GOLDENS.read_text())
    if goldens['sample'] != fit_goldens['sample']:
        fail('the sampler goldens and the fit goldens sample differently')
    out = Path(work) / 'samplers'
    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None), \
            switch('VEGA_TPU_NS_DEVICE_LOOP', None):
        launches, replays, checks = run_ns_paths(device, fit_ini, out,
                                                 goldens, fit_goldens)
        run_smc_path(device, fit_ini, out, goldens, fit_goldens)
        hmc_launches, hmc_replays, hmc_checks = run_hmc_paths(
            device, fit_ini, out, goldens, fit_goldens)
    log(f'sampler phase: {time.perf_counter() - t0:.1f} s')
    return ({**launches, **hmc_launches}, {**replays, **hmc_replays},
            checks + hmc_checks)


# ----------------------------------------------------------------------
# The DR16-shaped model: metals, HCD, small-scale NL
# ----------------------------------------------------------------------
def watch_metals(vega):
    """Record the kernel launches made inside each model's metal stack
    (`Metals.compute`) apart from the rest: returns the {layout:
    RecordedLayout} dict they accumulate in."""
    return watch_calls([(model.metals, 'compute')
                        for model in vega.models.values()])


def watch_calls(targets):
    """Record the kernel launches made inside each (owner, attribute)
    method of `targets` apart from the rest: returns the {layout:
    RecordedLayout} dict they accumulate in."""
    from vega_tpu_torch.ops.spline_combine import recorded_launches
    seen = {}
    for owner, name in targets:
        def call(*args, _inner=getattr(owner, name), **kwargs):
            with recorded_launches() as layouts:
                out = _inner(*args, **kwargs)
            for key, record in layouts.items():
                if key in seen:
                    seen[key].launches += record.launches
                else:
                    seen[key] = record
            return out
        setattr(owner, name, call)
    return seen


def metal_launches(seen, primitive):
    return sum(r.launches for key, r in seen.items() if key[0] == primitive)


def device_shares(device, vega, batches, hooks=None):
    """Device ms of one chi2_batch(batches), and within it of the parts
    `hooks` names ({key: [(owner, attribute)]}; default the metal stacks
    and the power-spectrum grids, compute_peak_smooth: Kaiser with HCD,
    NL, G(k), peak broadening), from CUDA events around each call of them
    (the dense path keeps the device busy, so the time between two events
    is device work)."""
    if hooks is None:
        hooks = {'metals': [(m.metals, 'compute')
                            for m in vega.models.values()],
                 'pk': [(m.Pk_core, 'compute_peak_smooth')
                        for m in vega.models.values()]}
    spans = {key: [] for key in hooks}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            spans[key].append((start, stop))
            return out
        return wrapper

    saved = []
    for key, targets in hooks.items():
        for owner, name in targets:
            fn = getattr(owner, name)
            saved.append((owner, name, fn))
            setattr(owner, name, timed(fn, key))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    vega.chi2_batch(batches)
    stop.record()
    torch.cuda.synchronize(device)
    for owner, name, fn in saved:
        setattr(owner, name, fn)
    total = start.elapsed_time(stop)
    return total, {key: sum(a.elapsed_time(b) for a, b in pairs)
                   for key, pairs in spans.items()}


def run_dr16_path(device, work, card):
    """Phase dr16 (see the module docstring); returns the kernel launches
    of its three paths and the kernel checks at their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import (DR16_METALS, dr16_extra_model,
                                        make_synthetic_dataset)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(DR16_GOLDENS.read_text())
    names = goldens['names']
    t_phase = time.perf_counter()
    main_ini = make_synthetic_dataset(
        Path(work) / 'dr16', cross=True, size='full', device=device,
        sample=goldens['sample'], extra_model=dr16_extra_model(),
        metals=list(DR16_METALS))
    log(f'dr16: configuration synthetic-dr16-full in '
        f'{time.perf_counter() - t_phase:.2f} s')
    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(main_ini, device=device)
    log(f'dr16 dense: interface in {time.perf_counter() - t0:.2f} s; metal '
        'pairs ' + ', '.join(
            f'{n} {len(item.metal_correlations)} in '
            f'{len(dense_vega.models[n].metals._stacked_plans)} classes'
            for n, item in dense_vega.corr_items.items()))
    rng = np.random.default_rng(0)
    batches = {n: dense_vega.params[n] + 0.01 * abs(dense_vega.params[n])
               * rng.normal(size=BATCH) for n in names}
    launches, checks = {}, []

    # --- the dense regime: counts from zero
    seen = watch_metals(dense_vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        chi2_default = dense_vega.chi2()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = dense_vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches['dr16_dense'] = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    checks += check_launches(device, 'dr16_dense', layouts)
    if not abs(chi2_default) < DEFAULT_CHI2_MAX:
        fail(f'dr16 chi2 at the defaults {chi2_default!r} >= '
             f'{DEFAULT_CHI2_MAX}')
    chi2_np = chi2.cpu().numpy()
    if chi2_np.shape != (BATCH,) or not np.all(np.isfinite(chi2_np)) \
            or np.any(chi2_np >= 1e100):
        fail('dr16 dense chi2_batch is not finite of shape (8192,) '
             'without a penalty')
    n_metal = metal_launches(seen, 'F')
    log(f'dr16 dense chi2_batch({BATCH}): chi2 at the defaults '
        f'{chi2_default!r}, first call {first_s:.3f} s, peak device memory '
        f'{peak_gb:.2f} GB, chi2 in [{chi2_np.min():.6g}, '
        f'{chi2_np.max():.6g}], kernel launches {launches["dr16_dense"]}, '
        f'{n_metal} of F_0 from the metal stack at '
        + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen))
    if not n_metal:
        fail('the dr16 dense path launched no F_0 from metals.py')

    plain = dense_vega.chi2_batch(batches, use_kernel=False).cpu().numpy()
    rel = float(np.max(np.abs(plain - chi2_np) / np.abs(plain)))
    log(f'dr16 dense kernel path vs plain path: max relative diff {rel:.3e}')
    if not rel <= PLAIN_RTOL:
        fail(f'dr16 kernel path vs plain path differ by {rel:.3e}')
    got = dense_vega.chi2_batch(goldens['params']).cpu().numpy()
    want = np.asarray(goldens['chi2_dense'])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f'dr16 dense vs JAX goldens ({len(want)} points): max relative '
        f'diff {rel:.3e}')
    if not rel <= GOLDEN_RTOL:
        fail(f'dr16 dense chi2 vs the JAX goldens differ by {rel:.3e} > '
             f'{GOLDEN_RTOL}')
    times = []
    for _ in range(TIMED_ROUNDS):
        for name in batches:
            batches[name] = batches[name] + 1e-9
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dense_vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    log(f'dr16 dense chi2_batch({BATCH}): '
        f'{BATCH / np.median(times):.1f} evals/s (median of '
        f'{TIMED_ROUNDS}, s per call '
        f'{", ".join(f"{t:.4f}" for t in times)})')
    total_ms, parts = device_shares(device, dense_vega, batches)
    log(f'dr16 dense chi2_batch({BATCH}) on CUDA events: {total_ms:.1f} ms; '
        f'metal stacks {parts["metals"]:.1f} ms '
        f'({parts["metals"] / total_ms:.1%}), power-spectrum grids (HCD '
        f'Kaiser, NL, G(k), peak) {parts["pk"]:.1f} ms '
        f'({parts["pk"] / total_ms:.1%}), the rest (transform, combine, '
        f'chi^2) {total_ms - sum(parts.values()):.1f} ms')
    profile_call(f'dr16 dense chi2_batch({BATCH})',
                 lambda: dense_vega.chi2_batch(batches).cpu(), device)

    # --- the grid regime: counts from zero
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid_vega = VegaInterface(main_ini, device=device)
    seen_grid = watch_metals(grid_vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        payload = grid_vega.get_collapsed(frozenset(names))
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        chi2 = grid_vega.chi2_batch(batches).cpu().numpy()
    launches['dr16_grid'] = dict(LAUNCHES)
    checks += check_launches(device, 'dr16_grid', layouts)
    stats = grid_vega.grid_stats
    log(f'dr16 grid collapse: {payload["__grid__"]}, {stats["nodes"]} '
        f'nodes; chi^2 constants {stats["constants_s"]:.3f} s, device sweep '
        f'{stats["sweep_s"]:.3f} s, host payload build '
        f'{stats["host_s"]:.3f} s, total {collapse_s:.3f} s; kernel '
        f'launches {launches["dr16_grid"]}, '
        f'{metal_launches(seen_grid, "F")} of F_0 from the metal stack at '
        + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen_grid))
    for name in grid_vega.corr_items:
        if name not in payload:
            fail(f'dr16: {name} is not served by the grid payload')
        p, want = payload[name], goldens['payload'][name]
        log(f'  {name}: T = {p["cref"].shape[0]}, retained modes '
            f'A {p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
            f'SVD rank A {p["B_A"].shape[1]} / sy {p["B_sy"].shape[1]} '
            f'(JAX package: T = {want["terms"]}, modes {want["modes_A"]} / '
            f'{want["modes_sy"]}, rank {want["rank_A"]} / '
            f'{want["rank_sy"]}), dc_max {float(p["dc_max"]):.6g}')
        if p['cref'].shape[0] != want['terms']:
            fail(f'dr16: {name} has {p["cref"].shape[0]} terms, the JAX '
                 f'package {want["terms"]}')
    if not metal_launches(seen_grid, 'F'):
        fail('the dr16 grid sweep launched no F_0 from metals.py')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)) \
            or np.any(chi2 >= 1e100):
        fail('dr16 grid chi2_batch is not finite without a penalty')
    got = grid_vega.chi2_batch(goldens['params']).cpu().numpy()
    want_grid = np.asarray(goldens['chi2_grid'])
    d_grid = np.abs(got - want_grid)
    bound = GRID_ABS_TOL + GRID_REL_TOL * np.abs(want_grid)
    log(f'dr16 grid vs JAX grid goldens ({len(got)} points): max |d chi2| '
        f'{d_grid.max():.3e} (bound {bound.min():.3e} .. {bound.max():.3e}); '
        f'vs the JAX dense chi2 {np.abs(got - goldens["chi2_dense"]).max():.6g}'
        f' (the JAX grid path\'s own {goldens["max_abs_grid_minus_dense"]:.6g})')
    if not np.all(d_grid <= bound):
        fail(f'dr16 grid chi2 vs the JAX grid chi2: |d| {d_grid.max():.3e} '
             'over the bound')
    rates = {}
    for n_rows in GRID_BATCHES:
        rows = {n: grid_vega.params[n] + 0.01 * abs(grid_vega.params[n])
                * rng.normal(size=n_rows) for n in names}
        grid_vega.chi2_batch(rows).cpu()
        per_round = []
        for _ in range(GRID_ROUNDS):
            for name in rows:
                rows[name] = rows[name] + 1e-9
            t0 = time.perf_counter()
            grid_vega.chi2_batch(rows).cpu()
            per_round.append(n_rows / (time.perf_counter() - t0))
        rates[n_rows] = float(np.median(per_round))
        log(f'dr16 grid chi2_batch({n_rows}): {rates[n_rows]:.1f} evals/s '
            f'(median of {GRID_ROUNDS}; per round '
            f'{", ".join(f"{r:.1f}" for r in per_round)})')
    log(f'dr16 grid path peak device memory (collapse and both batches): '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB')
    log(json.dumps({
        'metric': 'likelihood evals/sec/chip',
        'value': round(rates[BATCH], 3),
        'unit': f'evals/s/chip (synthetic-dr16-full, batch={BATCH}, f64, 1 '
                f'chip(s), {card}, vega_tpu_torch, collapse='
                f'{collapse_s:.1f}s; batch {GRID_BATCHES[1]}: '
                f'{rates[GRID_BATCHES[1]]:.1f})'}))
    profile_call(f'dr16 grid chi2_batch({BATCH})',
                 lambda: grid_vega.chi2_batch(batches).cpu(), device)

    # --- the fit in each regime: counts from zero
    points = goldens['derivative_points']
    seen.clear()
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        grid = derivatives_at(device, grid_vega, points, names,
                              'dr16 fit grid regime')
        compare_derivatives(
            'dr16 fit grid regime vs JAX grid goldens', grid,
            goldens['grid'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_GRID_RTOL))
        timed_fit(device, grid_vega, 'dr16 grid')
        check_fit('dr16 grid', 'grid', grid_vega, names, goldens['fit_grid'])
        dense = derivatives_at(device, dense_vega, points, names,
                               'dr16 fit dense regime')
        compare_derivatives(
            'dr16 fit dense regime vs JAX dense goldens', dense,
            goldens['dense'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_DENSE_RTOL))
        timed_fit(device, dense_vega, 'dr16 dense')
        check_fit('dr16 dense', 'dense', dense_vega, names,
                  goldens['fit_dense'])
    launches['dr16_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'dr16_fit', layouts)
    # the backward's launches come from autograd, outside Metals.compute:
    # they are the fit's launches at the (B, M) of the stack's forward
    # launches (B = pairs: 14 / 4; the core model's have B = 1)
    metal_shapes = {(key[2], key[7]) for key in seen}
    by_primitive = {
        primitive: sum(r.launches for key, r in layouts.items()
                       if key[0] == primitive
                       and (key[2], key[7]) in metal_shapes)
        for primitive in ('F', 'P', 'Ft')}
    log(f'dr16 fit kernel launches: {launches["dr16_fit"]}; at the metal '
        f'stack\'s layouts (B, M) {sorted(metal_shapes)}: {by_primitive}, '
        f'{metal_launches(seen, "F")} of them F_0 inside Metals.compute')
    if not by_primitive['F'] or not by_primitive['Ft']:
        fail('the dr16 dense fit launched no F_d or no Ft_d from metals.py')
    log(f'dr16 phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# ----------------------------------------------------------------------
# The reference's own model terms: UV fluctuations and shotnoise, the
# relativistic and asymmetry terms, Croom's evolution, and the variants
# ----------------------------------------------------------------------
UV_ROUNDS = 2


def legacy_targets(vega):
    return [(m.PktoXi, f'pk_to_xi_{term}') for m in vega.models.values()
            for term in ('relativistic', 'asymmetry')]


def timed_rows(device, vega, batches, rounds):
    """evals/s of chi2_batch(batches): the median of `rounds` calls, the
    rows moved by 1e-9 before each, and the s per call."""
    times = []
    n_rows = len(next(iter(batches.values())))
    for _ in range(rounds):
        for name in batches:
            batches[name] = batches[name] + 1e-9
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        vega.chi2_batch(batches).cpu()
        times.append(time.perf_counter() - t0)
    return n_rows / float(np.median(times)), times


def value_gradients(device, vega, points, names, label):
    """chi^2 and gradient at each point, laid out as the goldens keep
    them, with the wall time of each call."""
    out = {'chi2': [], 'gradient': []}
    times = []
    for point in points:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        value, grad = vega.chi2_value_and_gradient(point)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        out['chi2'].append(value)
        out['gradient'].append([grad[n] for n in names])
    log(f'{label}: value and gradient at {len(points)} points, s per call '
        + ', '.join(f'{t:.4f}' for t in times))
    return out


def run_uv_path(device, work, card):
    """Phase uv (see the module docstring); returns the kernel launches
    of its paths, the kernel checks at their layouts and the edge checks
    on its two new knot grids."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import dataset_variant, make_dr16_uv_dataset
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(UV_GOLDENS.read_text())
    names = goldens['names']
    t_phase = time.perf_counter()
    main_ini = make_dr16_uv_dataset(Path(work) / 'uv', size='full',
                                    device=device, sample=goldens['sample'])
    log(f'uv: configuration synthetic-dr16-uv-full in '
        f'{time.perf_counter() - t_phase:.2f} s')
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(main_ini, device=device)
    rng = np.random.default_rng(0)
    spread = {n: 0.01 * abs(v) for n, v in dense_vega.params.items()}
    spread['uv_shotnoise_amp'] = 1e-4
    batches = {n: dense_vega.params[n] + spread[n] * rng.normal(size=BATCH)
               for n in names}
    launches, checks = {}, []

    # --- the dense regime: counts from zero
    legacy = watch_calls(legacy_targets(dense_vega))
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = dense_vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches['uv_dense'] = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    checks += check_launches(device, 'uv_dense', layouts)
    chi2_np = chi2.cpu().numpy()
    if chi2_np.shape != (BATCH,) or not np.all(np.isfinite(chi2_np)) \
            or np.any(chi2_np >= 1e100):
        fail(f'uv dense chi2_batch is not finite of shape ({BATCH},) '
             'without a penalty')
    n_legacy = metal_launches(legacy, 'F')
    log(f'uv dense chi2_batch({BATCH}): first call {first_s:.3f} s, peak '
        f'device memory {peak_gb:.2f} GB, chi2 in [{chi2_np.min():.6g}, '
        f'{chi2_np.max():.6g}], kernel launches {launches["uv_dense"]}, '
        f'{n_legacy} of F_0 from the relativistic and asymmetry terms at '
        + '; '.join(layout_label(k[0], k[1], k[2:]) for k in legacy))
    if not n_legacy or any(k[3] != 2 for k in legacy):
        fail('the uv dense path launched no F_0 of two tables from the '
             'relativistic and asymmetry terms')
    plain = dense_vega.chi2_batch(batches, use_kernel=False).cpu().numpy()
    rel = float(np.max(np.abs(plain - chi2_np) / np.abs(plain)))
    log(f'uv dense kernel path vs plain path: max relative diff {rel:.3e}')
    if not rel <= PLAIN_RTOL:
        fail(f'uv kernel path vs plain path differ by {rel:.3e}')
    got = dense_vega.chi2_batch(goldens['params']).cpu().numpy()
    want = np.asarray(goldens['chi2_dense'])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f'uv dense vs JAX goldens ({len(want)} points): max relative diff '
        f'{rel:.3e}')
    if not rel <= GOLDEN_RTOL:
        fail(f'uv dense chi2 vs the JAX goldens differ by {rel:.3e} > '
             f'{GOLDEN_RTOL}')
    rate, times = timed_rows(device, dense_vega, batches, UV_ROUNDS)
    log(f'uv dense chi2_batch({BATCH}): {rate:.1f} evals/s (median of '
        f'{UV_ROUNDS}, s per call {", ".join(f"{t:.4f}" for t in times)}; '
        f'{card})')

    # --- vega_tpu's route: the auto from the payload, the cross dense
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        route_vega = VegaInterface(main_ini, device=device)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        t0 = time.perf_counter()
        payload = route_vega.get_collapsed(frozenset(names))
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        chi2 = route_vega.chi2_batch(batches).cpu().numpy()
    launches['uv_route'] = dict(LAUNCHES)
    checks += check_launches(device, 'uv_route', layouts)
    stats = route_vega.grid_stats
    log(f'uv route collapse: {payload.get("__grid__")}, {stats["nodes"]} '
        f'nodes, sweep {stats["sweep_s"]:.3f} s, host payload build '
        f'{stats["host_s"]:.3f} s, total {collapse_s:.3f} s; served from '
        f'the payload {sorted(payload)} (JAX package: '
        f'{goldens["route_keys"]}); kernel launches {launches["uv_route"]}')
    if sorted(payload) != goldens['route_keys']:
        fail(f'uv route serves {sorted(payload)} from the payload, the JAX '
             f'package {goldens["route_keys"]}')
    for name, want in goldens['payload'].items():
        if payload[name]['cref'].shape[0] != want['terms']:
            fail(f'uv: {name} has {payload[name]["cref"].shape[0]} terms, '
                 f'the JAX package {want["terms"]}')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)) \
            or np.any(chi2 >= 1e100):
        fail('uv route chi2_batch is not finite without a penalty')
    got = route_vega.chi2_batch(goldens['params']).cpu().numpy()
    want = np.asarray(goldens['chi2_route'])
    d_route = np.abs(got - want)
    bound = GRID_ABS_TOL + GRID_REL_TOL * np.abs(want)
    log(f'uv route vs JAX route goldens ({len(got)} points): max |d chi2| '
        f'{d_route.max():.3e} (bound {bound.min():.3e} .. '
        f'{bound.max():.3e})')
    if not np.all(d_route <= bound):
        fail(f'uv route chi2 vs the JAX route chi2: |d| {d_route.max():.3e} '
             'over the bound')
    rate, times = timed_rows(device, route_vega, batches, UV_ROUNDS)
    log(f'uv route chi2_batch({BATCH}): {rate:.1f} evals/s (median of '
        f'{UV_ROUNDS}, s per call {", ".join(f"{t:.4f}" for t in times)}; '
        f'{card})')

    # --- value and gradient in both, and the dense fit: counts from zero
    legacy.clear()
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        points = goldens['derivative_points']
        compare_derivatives(
            'uv route value and gradient vs JAX goldens',
            value_gradients(device, route_vega, points, names, 'uv route'),
            goldens['route'], {'chi2': FIT_GRID_RTOL,
                               'gradient': FIT_GRID_RTOL})
        compare_derivatives(
            'uv dense value and gradient vs JAX goldens',
            value_gradients(device, dense_vega, points, names, 'uv dense'),
            goldens['dense'], {'chi2': FIT_DENSE_RTOL,
                               'gradient': FIT_DENSE_RTOL})
        timed_fit(device, dense_vega, 'uv dense')
        check_fit('uv dense', 'dense', dense_vega, names,
                  goldens['fit_dense'])
    launches['uv_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'uv_fit', layouts)
    legacy_ft = sum(r.launches for key, r in layouts.items()
                    if key[0] == 'Ft' and key[3] == 2)
    log(f'uv fit kernel launches: {launches["uv_fit"]}; Ft_d of two tables '
        f'(the relativistic and asymmetry terms\' backward): {legacy_ft}')
    if not legacy_ft:
        fail('the uv dense fit launched no Ft_d of the legacy terms')

    # --- the variants, one dense evaluation each: counts from zero
    variant_grids = {}
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        point = {k: np.asarray([v])
                 for k, v in goldens['variant_point'].items()}
        for label, entry in goldens['variants'].items():
            t0 = time.perf_counter()
            with switch('VEGA_TPU_FACTORED', '0'):
                vega = VegaInterface(dataset_variant(
                    main_ini, Path(work) / f'uv_{label}',
                    **entry['changes']), device=device)
            value = float(vega.chi2_batch(point).cpu().numpy()[0])
            rel = abs(value - entry['chi2_dense']) / abs(entry['chi2_dense'])
            log(f'uv variant {label}: dense chi2 {value!r} (JAX '
                f'{entry["chi2_dense"]!r}, relative diff {rel:.3e}) in '
                f'{time.perf_counter() - t0:.2f} s')
            if not rel <= GOLDEN_RTOL:
                fail(f'uv variant {label}: dense chi2 differs from the JAX '
                     f'golden by {rel:.3e}')
            if label == 'fht_extrap':
                variant_grids['fht_extrap'] = \
                    vega.models['lyaxlya'].PktoXi.knot_grid
    launches['uv_variants'] = dict(LAUNCHES)
    checks += check_launches(device, 'uv_variants', layouts)
    single = sum(r.launches for key, r in layouts.items()
                 if key[0] == 'F' and key[3] == 1)
    if not single:
        fail('the single_multipole variant launched no F_0 of one table')

    # --- edge layouts on the new knot grids
    legacy_grid = dense_vega.models['qsoxlya'].PktoXi.legacy_operators(
        (1, 3), 1)[0]
    edge = check_edge_layouts(device, legacy_grid, 2,
                              'legacy, relativistic pair')
    edge += check_edge_layouts(device, variant_grids['fht_extrap'], 4,
                               'fht_extrap')
    log(f'uv phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks, edge


# ----------------------------------------------------------------------
# The DESI DR1 baseline model: new-metals matrices, QSO radiation, DESI
# instrumental systematics, the joint covariance
# ----------------------------------------------------------------------
def desi_rows(params, names, n_rows, rng):
    """Rows 1% around the configuration's values (0.001 around a zero
    value), as the goldens draw their points."""
    return {n: params[n] + 0.01 * (abs(params[n]) or 0.1)
            * rng.normal(size=n_rows) for n in names}


def desi_shares(device, vega, batches):
    """Device ms of one dense chi2_batch and, on CUDA events, of its
    metal matrices' GEMMs, the metal stack's combine, the power-spectrum
    grids and the joint quadratic form."""
    import vega_tpu_torch.metals as metals_mod
    import vega_tpu_torch.vega_interface as vi_mod
    models = list(vega.models.values())
    total_ms, parts = device_shares(device, vega, batches, hooks={
        'metal matrices': [(m.metals, 'apply_metal_matrix') for m in models],
        'metal combine': [(metals_mod, 'spline_legendre_combine')],
        'pk': [(m.Pk_core, 'compute_peak_smooth') for m in models],
        'joint form': [(vi_mod, 'quadratic_rows')]})
    log(f'desi dense chi2_batch({BATCH}) on CUDA events: {total_ms:.1f} ms; '
        + ', '.join(f'{key} {ms:.1f} ms ({ms / total_ms:.1%})'
                    for key, ms in parts.items())
        + f'; the rest (transform, core combine, Kaiser moments) '
        f'{total_ms - sum(parts.values()):.1f} ms')


def run_desi_path(device, work, card):
    """Phase desi (see the module docstring); returns the kernel launches
    of its three paths and the kernel checks at their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import (DESI_METALS, desi_extra_model,
                                        make_synthetic_dataset)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(DESI_GOLDENS.read_text())
    names, grid_names = goldens['names'], goldens['grid_names']
    t_phase = time.perf_counter()
    main_ini = make_synthetic_dataset(
        Path(work) / 'desi', cross=True, size='full', device=device,
        sample=goldens['sample'], extra_model=desi_extra_model(),
        metals=list(DESI_METALS), new_metals=True, global_cov=True,
        extra_control=goldens['extra_control'])
    log(f'desi: configuration synthetic-desi-full in '
        f'{time.perf_counter() - t_phase:.2f} s')
    t0 = time.perf_counter()
    dense_vega = VegaInterface(main_ini, device=device)
    log(f'desi dense (joint covariance): interface in '
        f'{time.perf_counter() - t0:.2f} s, of it the new-metals matrices '
        'on the host ' + ', '.join(
            f'{n} {len(item.metal_correlations)} pairs '
            f'{dense_vega.models[n].metals.matrix_build_s:.3f} s'
            for n, item in dense_vega.corr_items.items()))
    rng = np.random.default_rng(0)
    batches = desi_rows(dense_vega.params, names, BATCH, rng)
    launches, checks = {}, []

    # --- the dense regime under the joint covariance: counts from zero
    seen = watch_metals(dense_vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        chi2_default = dense_vega.chi2()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = dense_vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches['desi_dense'] = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    checks += check_launches(device, 'desi_dense', layouts)
    # the defaults sit off the priors' means: chi^2 there is the priors'
    d_default = abs(chi2_default - goldens['chi2_default'])
    if not d_default <= GOLDEN_RTOL * abs(goldens['chi2_default']):
        fail(f'desi chi2 at the defaults {chi2_default!r}, the JAX '
             f'package {goldens["chi2_default"]!r}')
    chi2_np = chi2.cpu().numpy()
    if chi2_np.shape != (BATCH,) or not np.all(np.isfinite(chi2_np)) \
            or np.any(chi2_np >= 1e100):
        fail('desi dense chi2_batch is not finite of shape (8192,) '
             'without a penalty')
    n_metal = metal_launches(seen, 'F')
    log(f'desi dense chi2_batch({BATCH}), {len(names)} names: chi2 at the '
        f'defaults {chi2_default!r} (the priors\'; JAX '
        f'{goldens["chi2_default"]!r}), first call {first_s:.3f} s, peak '
        f'device memory {peak_gb:.2f} GB, chi2 in [{chi2_np.min():.6g}, '
        f'{chi2_np.max():.6g}], kernel launches {launches["desi_dense"]}, '
        f'{n_metal} of F_0 from the metal stack at '
        + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen))
    if not n_metal:
        fail('the desi dense path launched no F_0 from metals.py')
    plain = dense_vega.chi2_batch(batches, use_kernel=False).cpu().numpy()
    rel = float(np.max(np.abs(plain - chi2_np) / np.abs(plain)))
    log(f'desi dense kernel path vs plain path: max relative diff {rel:.3e}')
    if not rel <= PLAIN_RTOL:
        fail(f'desi kernel path vs plain path differ by {rel:.3e}')
    got = dense_vega.chi2_batch(goldens['params']).cpu().numpy()
    want = np.asarray(goldens['chi2_dense'])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f'desi dense vs JAX goldens ({len(want)} points): max relative '
        f'diff {rel:.3e}')
    if not rel <= GOLDEN_RTOL:
        fail(f'desi dense chi2 vs the JAX goldens differ by {rel:.3e} > '
             f'{GOLDEN_RTOL}')
    times = []
    for _ in range(DESI_TIMED_ROUNDS):
        for name in batches:
            batches[name] = batches[name] + 1e-9
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dense_vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    log(f'desi dense chi2_batch({BATCH}): '
        f'{BATCH / np.median(times):.1f} evals/s (median of '
        f'{DESI_TIMED_ROUNDS}, s per call '
        f'{", ".join(f"{t:.4f}" for t in times)})')
    desi_shares(device, dense_vega, batches)
    profile_call(f'desi dense chi2_batch({BATCH})',
                 lambda: dense_vega.chi2_batch(batches).cpu(), device)

    # --- the grid regime, per-correlation covariances: counts from zero
    grid_main = Path(main_ini).parent / 'main_grid.ini'
    grid_main.write_text(re.sub(r'global-cov-file = .*\n', '\n',
                                Path(main_ini).read_text()))
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid_vega = VegaInterface(grid_main, device=device)
    grid_batches = desi_rows(grid_vega.params, grid_names, BATCH, rng)
    seen_grid = watch_metals(grid_vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        payload = grid_vega.get_collapsed(frozenset(grid_names))
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        chi2 = grid_vega.chi2_batch(grid_batches).cpu().numpy()
    launches['desi_grid'] = dict(LAUNCHES)
    checks += check_launches(device, 'desi_grid', layouts)
    stats = grid_vega.grid_stats
    log(f'desi grid collapse ({len(grid_names)} names): '
        f'{payload["__grid__"]}, {stats["nodes"]} nodes; chi^2 constants '
        f'{stats["constants_s"]:.3f} s, device sweep {stats["sweep_s"]:.3f} '
        f's, host payload build {stats["host_s"]:.3f} s, total '
        f'{collapse_s:.3f} s; kernel launches {launches["desi_grid"]}, '
        f'{metal_launches(seen_grid, "F")} of F_0 from the metal stack at '
        + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen_grid))
    for name in grid_vega.corr_items:
        if name not in payload:
            fail(f'desi: {name} is not served by the grid payload')
        p, want = payload[name], goldens['payload'][name]
        log(f'  {name}: T = {p["cref"].shape[0]}, retained modes '
            f'A {p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
            f'SVD rank A {p["B_A"].shape[1]} / sy {p["B_sy"].shape[1]} '
            f'(JAX package: T = {want["terms"]}, modes {want["modes_A"]} / '
            f'{want["modes_sy"]}, rank {want["rank_A"]} / '
            f'{want["rank_sy"]}), dc_max {float(p["dc_max"]):.6g}')
        if p['cref'].shape[0] != want['terms']:
            fail(f'desi: {name} has {p["cref"].shape[0]} terms, the JAX '
                 f'package {want["terms"]}')
    if not metal_launches(seen_grid, 'F'):
        fail('the desi grid sweep launched no F_0 from metals.py')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)) \
            or np.any(chi2 >= 1e100):
        fail('desi grid chi2_batch is not finite without a penalty')
    got = grid_vega.chi2_batch({n: goldens['params'][n]
                                for n in grid_names}).cpu().numpy()
    want_grid = np.asarray(goldens['chi2_grid'])
    d_grid = np.abs(got - want_grid)
    bound = GRID_ABS_TOL + GRID_REL_TOL * np.abs(want_grid)
    log(f'desi grid vs JAX grid goldens ({len(got)} points): max |d chi2| '
        f'{d_grid.max():.3e} (bound {bound.min():.3e} .. {bound.max():.3e}); '
        f'vs the JAX dense chi2 '
        f'{np.abs(got - goldens["chi2_grid_dense"]).max():.6g} (the JAX grid '
        f'path\'s own {goldens["max_abs_grid_minus_dense"]:.6g})')
    if not np.all(d_grid <= bound):
        fail(f'desi grid chi2 vs the JAX grid chi2: |d| {d_grid.max():.3e} '
             'over the bound')
    rates = {}
    for n_rows in GRID_BATCHES:
        rows = desi_rows(grid_vega.params, grid_names, n_rows, rng)
        grid_vega.chi2_batch(rows).cpu()
        per_round = []
        for _ in range(GRID_ROUNDS):
            for name in rows:
                rows[name] = rows[name] + 1e-9
            t0 = time.perf_counter()
            grid_vega.chi2_batch(rows).cpu()
            per_round.append(n_rows / (time.perf_counter() - t0))
        rates[n_rows] = float(np.median(per_round))
        log(f'desi grid chi2_batch({n_rows}): {rates[n_rows]:.1f} evals/s '
            f'(median of {GRID_ROUNDS}; per round '
            f'{", ".join(f"{r:.1f}" for r in per_round)})')
    log(f'desi grid path peak device memory (collapse and both batches): '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB')
    log(json.dumps({
        'metric': 'likelihood evals/sec/chip',
        'value': round(rates[BATCH], 3),
        'unit': f'evals/s/chip (synthetic-desi-full, batch={BATCH}, f64, 1 '
                f'chip(s), {card}, vega_tpu_torch, collapse='
                f'{collapse_s:.1f}s; batch {GRID_BATCHES[1]}: '
                f'{rates[GRID_BATCHES[1]]:.1f})'}))
    profile_call(f'desi grid chi2_batch({BATCH})',
                 lambda: grid_vega.chi2_batch(grid_batches).cpu(), device)
    del grid_vega

    # --- the fit under the joint covariance, and a global mock's: counts
    # from zero
    seen.clear()
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        dense = derivatives_at(device, dense_vega,
                               goldens['derivative_points'], names,
                               'desi fit dense regime')
        compare_derivatives(
            'desi fit dense regime vs JAX dense goldens', dense,
            goldens['dense'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_DENSE_RTOL))
        timed_fit(device, dense_vega, 'desi dense')
        check_fit('desi dense', 'joint', dense_vega, names,
                  goldens['fit_dense'])
        # the mock's initial fit is the fit above, as in the goldens
        dense_vega.minimize = lambda: None
        t0 = time.perf_counter()
        mock = np.asarray(dense_vega.initialize_monte_carlo())
        mock_s = time.perf_counter() - t0
        del dense_vega.minimize
        want = goldens['mock']
        d_mock = max(abs(mock.sum() - want['sum']) / abs(want['sum']),
                     rel_err(mock[:len(want['first'])], want['first']))
        log(f'desi global mock (seed {goldens["mc_seed"]}, '
            f'{mock.size} bins, numpy legacy draw) in {mock_s:.3f} s: '
            f'sum {mock.sum()!r} (JAX {want["sum"]!r}), max relative diff '
            f'{d_mock:.3e}')
        if mock.size != want['size'] or not d_mock <= MOCK_RTOL:
            fail(f'desi global mock differs from the JAX one by {d_mock:.3e}')
        timed_fit(device, dense_vega, 'desi mock')
        check_fit('desi mock', 'joint', dense_vega, names,
                  goldens['fit_mock'])
    launches['desi_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'desi_fit', layouts)
    # the backward's launches come from autograd, outside Metals.compute:
    # they are the fit's launches at the (B, M) of the stack's forward
    # launches
    metal_shapes = {(key[2], key[7]) for key in seen}
    by_primitive = {
        primitive: sum(r.launches for key, r in layouts.items()
                       if key[0] == primitive
                       and (key[2], key[7]) in metal_shapes)
        for primitive in ('F', 'P', 'Ft')}
    log(f'desi fit kernel launches: {launches["desi_fit"]}; at the metal '
        f'stack\'s layouts (B, M) {sorted(metal_shapes)}: {by_primitive}, '
        f'{metal_launches(seen, "F")} of them F_0 inside Metals.compute')
    if not by_primitive['F'] or not by_primitive['Ft']:
        fail('the desi dense fit launched no F_d or no Ft_d from metals.py')
    log(f'desi phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# ----------------------------------------------------------------------
# eBOSS DR16's 13-name fit: the 4-dimension combination sweep, the payload
# cache, the results file and the Monte-Carlo scripts
# ----------------------------------------------------------------------
def table6_results_file(vega, work):
    """Write the fit's results as run_vega does and read them back with
    the port's FitResults: values, errors, covariance and FVAL equal to
    the minimizer's, each MODEL HDU's _MODEL column equal to
    bestfit_model, bit for bit."""
    from vega_tpu_torch.postprocess.fit_results import FitResults
    vega.output.outfile = str(Path(work) / 'table6_fit')
    vega.output.write_results(vega.bestfit_model, vega.params,
                              vega.minimizer, vega.bestfit_corr_stats)
    results = FitResults(vega.output.outfile + '.fits', no_chain=True)
    best = vega.minimizer
    names = [str(n) for n in results.names]
    if names != list(best.values):
        fail(f'table6 results file names {names} != {list(best.values)}')
    same = (results.chisq == best.fmin.fval
            and all(results.params[n] == best.values[n] for n in names)
            and all(results.sigmas[n] == best.errors[n] for n in names)
            and np.array_equal(results.cov, np.array(best.covariance)))
    models = all(np.array_equal(
        results.correlations[name.lower()].model, vega.bestfit_model[name])
        for name in vega.corr_items)
    log(f'table6 results file {vega.output.outfile}.fits read back with '
        f'FitResults: values, errors, covariance, FVAL bit-equal {same}; '
        f'MODEL columns bit-equal {models}')
    if not (same and models):
        fail('table6 results read back differ from the fit')


def table6_mc_scripts(work, fit_ini):
    """run_vega_mc.main([ini]) then run_vega_mc_fits.main([ini']) on the
    MOCKS it wrote: the fit configuration with [monte carlo] (bias_LYA,
    beta_LYA, served by the nuisance collapse) and num_mc_mocks =
    TABLE6_MC_MOCKS; the two Bestfit tables within MC_TABLE_RTOL."""
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.scripts import run_vega_mc, run_vega_mc_fits
    from vega_tpu_torch.vega_interface import parse_ini
    work = Path(work) / 'table6_mc'
    work.mkdir()
    config = parse_ini(fit_ini)
    config['control'].update({'run_montecarlo': 'True',
                              'num_mc_mocks': str(TABLE6_MC_MOCKS),
                              'mc_seed': '0'})
    config['output']['filename'] = str(work / 'output')
    config['monte carlo'] = {n: config['sample'][n]
                             for n in ('bias_LYA', 'beta_LYA')}
    config['mc parameters'] = {'bias_LYA': '-0.117', 'beta_LYA': '1.67'}
    ini = work / 'main_mc.ini'
    with open(ini, 'w') as fh:
        config.write(fh)
    t0 = time.perf_counter()
    run_vega_mc.main([str(ini)])
    mc_s = time.perf_counter() - t0
    mocks_file = work / 'monte_carlo' / 'monte_carlo.fits'
    config['control']['mc_mocks'] = str(mocks_file)
    config['output']['mc_output'] = str(work / 'refit')
    refit_ini = work / 'main_refit.ini'
    with open(refit_ini, 'w') as fh:
        config.write(fh)
    t0 = time.perf_counter()
    run_vega_mc_fits.main([str(refit_ini)])
    refit_s = time.perf_counter() - t0

    def table(path):
        return {h.name: h for h in read_fits(path)
                if getattr(h, 'name', '')}['Bestfit']
    first, second = table(mocks_file), table(work / 'refit' /
                                             'monte_carlo.fits')
    values = np.asarray(first['values'])
    if values.shape != (2, TABLE6_MC_MOCKS) or not np.all(
            np.isfinite(values)):
        fail(f'run_vega_mc Bestfit values of shape {values.shape}')
    worst = max(float(np.max(np.abs(np.asarray(second[col])
                                    - np.asarray(first[col]))
                             / np.abs(np.asarray(first[col]))))
                for col in ('values', 'errors'))
    log(f'table6 Monte-Carlo scripts: run_vega_mc {mc_s:.2f} s '
        f'({TABLE6_MC_MOCKS} mocks, initial fit included), '
        f'run_vega_mc_fits {refit_s:.2f} s on its MOCKS; Bestfit values '
        f'and errors agree to {worst:.3e} relative')
    if not worst <= MC_TABLE_RTOL:
        fail(f'the two Bestfit tables differ by {worst:.3e} > '
             f'{MC_TABLE_RTOL:g}')


def marg_coefficients(label, vega, point, want):
    """The template coefficients of the model at `point` against the JAX
    package's ({name: list}), MARG_COEFF_RTOL of their largest entry."""
    _, got = vega.chi2(point, return_marg_coeff=True)
    if sorted(got) != sorted(want):
        fail(f'{label}: coefficients of {sorted(got)}, the JAX package '
             f'{sorted(want)}')
    worst = max(rel_err(got[n], w) for n, w in want.items())
    log(f'{label}: template coefficients vs JAX ('
        + ', '.join(f'{n} {len(w)}' for n, w in want.items())
        + f'): max relative diff {worst:.3e} (bound {MARG_COEFF_RTOL:g})')
    if not worst <= MARG_COEFF_RTOL:
        fail(f'{label}: coefficients differ by {worst:.3e}')


def check_bestfit_coefficients(label, vega, names, want):
    """After minimize(): the best-fit coefficients in bestfit_corr_stats
    against those of the model at the JAX best fit (MARG_COEFF_RTOL at
    the JAX package's point; the port's own best fit reported), and the
    effective sizes."""
    stats = vega.bestfit_corr_stats
    at_jax = vega.compute_marg_coeff(vega.compute_model(
        dict(zip(names, want['values'])), run_init=False))
    worst = max(rel_err(at_jax[n], w)
                for n, w in want['bestfit_marg_coeff'].items())
    own = max(rel_err(stats[n]['bestfit_marg_coeff'], w)
              for n, w in want['bestfit_marg_coeff'].items())
    sizes = {n: s['masked_size'] for n, s in stats.items()}
    log(f'{label}: bestfit_marg_coeff at the JAX best fit vs JAX: max '
        f'relative diff {worst:.3e} (bound {MARG_COEFF_RTOL:g}); at the '
        f'port\'s own best fit {own:.3e}; effective sizes {sizes} (JAX '
        f'{want["masked_size"]})')
    if not worst <= MARG_COEFF_RTOL:
        fail(f'{label}: best-fit coefficients differ by {worst:.3e}')
    if sizes != want['masked_size']:
        fail(f'{label}: effective sizes {sizes}, the JAX package '
             f'{want["masked_size"]}')


def run_marg_path(device, work, card):
    """Phase marg (see the module docstring); returns the kernel launches
    of its paths and the kernel checks at their layouts."""
    import vega_tpu_torch.metals as metals_mod
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import (DESI_METALS, desi_extra_model,
                                        make_synthetic_dataset,
                                        marg_extra_model, with_control)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(MARG_GOLDENS.read_text())
    names = goldens['names']
    cov_goldens, in_fit_goldens = goldens['cov'], goldens['in_fit']
    t_phase = time.perf_counter()
    main_ini = make_synthetic_dataset(
        Path(work) / 'marg', cross=True, size='full', device=device,
        sample=goldens['sample'],
        extra_model=marg_extra_model(desi_extra_model()),
        metals=list(DESI_METALS), new_metals=True, with_distortion=True,
        noise=goldens['noise'])
    log(f'marg: configuration synthetic-desi-marg-full (the cross\'s '
        f'5,000 x 5,000 distortion matrix written twice) in '
        f'{time.perf_counter() - t_phase:.2f} s')
    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(main_ini, device=device)
    templates = {n: d.marg_templates.shape[1]
                 for n, d in dense_vega.data.items()}
    modes = dict(dense_vega.corr_num_marg_modes)
    log(f'marg dense: interface in {time.perf_counter() - t0:.2f} s; '
        'templates / retained modes / effective size per correlation: '
        + ', '.join(f'{n} {templates[n]} / {modes[n]} / '
                    f'{dense_vega.data[n].effective_data_size}'
                    for n in templates)
        + f' (JAX {cov_goldens["templates"]} / {cov_goldens["modes"]})')
    if templates != cov_goldens['templates'] \
            or modes != cov_goldens['modes']:
        fail('marg: the templates or modes differ from the JAX package\'s')
    launches, checks = {}, []
    models = list(dense_vega.models.values())

    # --- the templates in the covariance, dense: counts from zero
    mock_dense_regime(device, 'marg', dense_vega, cov_goldens, launches,
                      checks, hooks={
                          'metal matrices': [(m.metals, 'apply_metal_matrix')
                                             for m in models],
                          'metal combine': [(metals_mod,
                                             'spline_legendre_combine')],
                          'power-spectrum grids': [
                              (m.Pk_core, 'compute_peak_smooth')
                              for m in models]})
    marg_coefficients('marg dense', dense_vega,
                      cov_goldens['derivative_points'][0],
                      cov_goldens['coeff'])

    # --- the grid route on the updated covariance: counts from zero
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid_vega = VegaInterface(main_ini, device=device)
    seen_grid = watch_metals(grid_vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        t0 = time.perf_counter()
        payload = grid_vega.get_collapsed(frozenset(names))
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        rng = np.random.default_rng(1)
        grid_batches = desi_rows(grid_vega.params, names, BATCH, rng)
        chi2 = grid_vega.chi2_batch(grid_batches).cpu().numpy()
    launches['marg_grid'] = dict(LAUNCHES)
    checks += check_launches(device, 'marg_grid', layouts)
    stats = grid_vega.grid_stats
    log(f'marg grid cold build ({len(names)} names): {payload["__grid__"]}, '
        f'{stats["nodes"]} nodes; chi^2 constants {stats["constants_s"]:.3f} '
        f's, device sweep {stats["sweep_s"]:.3f} s, host payload build '
        f'{stats["host_s"]:.3f} s, total {collapse_s:.3f} s; kernel launches '
        f'{launches["marg_grid"]}, {metal_launches(seen_grid, "F")} of F_0 '
        'from the metal stacks')
    for name in grid_vega.corr_items:
        if name not in payload:
            fail(f'marg: {name} is not served by the grid payload')
        p, want = payload[name], cov_goldens['payload'][name]
        log(f'  {name}: T = {p["cref"].shape[0]}, retained modes '
            f'A {p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
            f'SVD rank A {p["B_A"].shape[1]} / sy {p["B_sy"].shape[1]} '
            f'(JAX package: T = {want["terms"]}, modes {want["modes_A"]} / '
            f'{want["modes_sy"]}, rank {want["rank_A"]} / '
            f'{want["rank_sy"]})')
        if p['cref'].shape[0] != want['terms']:
            fail(f'marg: {name} has {p["cref"].shape[0]} terms, the JAX '
                 f'package {want["terms"]}')
    if not metal_launches(seen_grid, 'F'):
        fail('the marg grid sweep launched no F_0 from metals.py')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)) \
            or np.any(chi2 >= 1e100):
        fail('marg grid chi2_batch is not finite without a penalty')
    got = grid_vega.chi2_batch(cov_goldens['params']).cpu().numpy()
    want_grid = np.asarray(cov_goldens['chi2_grid'])
    d_grid = np.abs(got - want_grid)
    bound = GRID_ABS_TOL + GRID_REL_TOL * np.abs(want_grid)
    log(f'marg grid vs JAX grid goldens ({len(got)} points): max |d chi2| '
        f'{d_grid.max():.3e} (bound {bound.min():.3e} .. {bound.max():.3e}); '
        f'vs the JAX dense chi2 '
        f'{np.abs(got - cov_goldens["chi2_grid_dense"]).max():.6g} (the JAX '
        f'grid path\'s own {cov_goldens["max_abs_grid_minus_dense"]:.6g})')
    if not np.all(d_grid <= bound):
        fail(f'marg grid chi2 vs the JAX grid chi2: |d| {d_grid.max():.3e} '
             'over the bound')
    rate, times = timed_rows(device, grid_vega, grid_batches, GRID_ROUNDS)
    log(f'marg grid chi2_batch({BATCH}): {rate:.1f} evals/s (median of '
        f'{GRID_ROUNDS}, s per call {", ".join(f"{t:.4f}" for t in times)})')
    del grid_vega

    # --- the dense fit on the updated covariance: counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        timed_fit(device, dense_vega, 'marg dense')
    launches['marg_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'marg_fit', layouts)
    check_fit('marg dense', 'dense', dense_vega, names,
              cov_goldens['fit_dense'])
    check_bestfit_coefficients('marg dense', dense_vega, names,
                               cov_goldens['fit_dense'])
    del dense_vega

    # --- marginalize-in-fit: the templates fitted per row; every call
    # dense (no collapse), counts from zero
    in_fit_ini = with_control(main_ini, 'marginalize-in-fit = True',
                              Path(main_ini).parent / 'main_in_fit.ini')
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        t0 = time.perf_counter()
        fit_vega = VegaInterface(in_fit_ini, device=device)
    log(f'marg in-fit: interface in {time.perf_counter() - t0:.2f} s')
    if fit_vega.get_collapsed(frozenset(names)) != {}:
        fail('marg in-fit: a collapse serves marginalize-in-fit')
    rng = np.random.default_rng(2)
    batches = desi_rows(fit_vega.params, names, BATCH, rng)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = fit_vega.chi2_batch(batches).cpu().numpy()
        first_s = time.perf_counter() - t0
    launches['marg_in_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'marg_in_fit', layouts)
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)) \
            or np.any(chi2 >= 1e100):
        fail('marg in-fit chi2_batch is not finite without a penalty')
    rate, times = timed_rows(device, fit_vega, batches, DESI_TIMED_ROUNDS)
    log(f'marg in-fit chi2_batch({BATCH}): first call {first_s:.3f} s, '
        f'peak device memory '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB, '
        f'{rate:.1f} evals/s (median of {DESI_TIMED_ROUNDS}, s per call '
        f'{", ".join(f"{t:.4f}" for t in times)}); kernel launches '
        f'{launches["marg_in_fit"]}')
    in_fit_models = list(fit_vega.models.values())
    total_ms, parts = device_shares(device, fit_vega, batches, hooks={
        'template fit (two GEMMs per correlation)': [
            (fit_vega, '_fit_marg_templates')],
        'power-spectrum grids': [(m.Pk_core, 'compute_peak_smooth')
                                 for m in in_fit_models]})
    log(f'marg in-fit chi2_batch({BATCH}) on CUDA events: {total_ms:.1f} ms; '
        + ', '.join(f'{key} {ms:.1f} ms ({ms / total_ms:.1%})'
                    for key, ms in parts.items())
        + f'; the rest {total_ms - sum(parts.values()):.1f} ms')
    want = np.asarray(in_fit_goldens['chi2_dense'])
    got = fit_vega.chi2_batch(in_fit_goldens['params']).cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    grads = []
    for point, value_w, grad_w in zip(in_fit_goldens['derivative_points'],
                                      in_fit_goldens['dense']['chi2'],
                                      in_fit_goldens['dense']['gradient']):
        value, grad = fit_vega.chi2_value_and_gradient(point)
        grads.append(max(abs(value / value_w - 1),
                         rel_err([grad[n] for n in names], grad_w)))
    log(f'marg in-fit vs JAX goldens: chi2 at {len(want)} points max '
        f'relative diff {rel:.3e}; value and gradient at {len(grads)} '
        f'points {max(grads):.3e}')
    if not rel <= GOLDEN_RTOL or not max(grads) <= GOLDEN_RTOL:
        fail(f'marg in-fit chi2 / gradient vs the JAX goldens differ by '
             f'{rel:.3e} / {max(grads):.3e} > {GOLDEN_RTOL}')
    marg_coefficients('marg in-fit', fit_vega,
                      in_fit_goldens['derivative_points'][0],
                      in_fit_goldens['coeff'])
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        timed_fit(device, fit_vega, 'marg in-fit')
    launches['marg_in_fit_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'marg_in_fit_fit', layouts)
    check_fit('marg in-fit', 'dense', fit_vega, names,
              in_fit_goldens['fit_dense'])
    check_bestfit_coefficients('marg in-fit', fit_vega, names,
                               in_fit_goldens['fit_dense'])
    for label in ('marg_fit', 'marg_in_fit_fit'):
        by_primitive = {primitive: sum(
            n for key, n in launches[label].items()
            if key[0] == primitive and (primitive != 'F' or key[1] >= 1))
            for primitive in ('F', 'P', 'Ft')}
        log(f'{label} kernel launches: F_d (d >= 1), P_d, Ft_d: '
            f'{by_primitive}')
        if not by_primitive['Ft']:
            fail(f'the {label} dense fit launched no Ft_d')
    log(f'marg phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


def run_table6_path(device, work, card, fit_ini):
    """Phase table6 (see the module docstring); returns the kernel
    launches of its sweep and the kernel checks at their layouts."""
    from vega_tpu_torch.gridcollapse import plan_components
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import (DR16_METALS, TABLE6_SAMPLE,
                                        dr16_extra_model,
                                        make_synthetic_dataset)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(TABLE6_GOLDENS.read_text())
    reference = json.loads(TABLE6_REFERENCE.read_text())
    names = goldens['names']
    points = goldens['params']
    t_phase = time.perf_counter()
    main_ini = make_synthetic_dataset(
        Path(work) / 'table6', cross=True, size='full', device=device,
        sample=TABLE6_SAMPLE, extra_model=dr16_extra_model(),
        metals=list(DR16_METALS))
    log(f'table6: configuration synthetic-dr16-table6-full in '
        f'{time.perf_counter() - t_phase:.2f} s')
    cache_dir = Path(work) / 'grid_cache_table6'
    launches, checks = {}, []
    with switch('VEGA_TPU_GRID_CACHE', None), \
            switch('VEGA_TPU_GRID_CACHE_DIR', str(cache_dir)), \
            switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        # --- the cold build: counts from zero
        vega = VegaInterface(main_ini, device=device)
        seen = watch_metals(vega)
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            payload = vega.get_collapsed(frozenset(names))
            torch.cuda.synchronize(device)
            cold_s = time.perf_counter() - t0
        launches['table6_sweep'] = dict(LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        stats = vega.grid_stats
        spec = payload['__grid__']
        components = plan_components(spec)
        swept = sum(int(np.prod(d)) for d, _ in components)
        log(f'table6 cold build: {spec}; {len(components)} components, '
            f'{swept} swept nodes (+ {stats["nodes"] - swept} held-out '
            f'probes; full tensor {spec.n_nodes}); chi^2 constants '
            f'{stats["constants_s"]:.3f} s, device sweep '
            f'{stats["sweep_s"]:.3f} s, host payload build '
            f'{stats["host_s"]:.3f} s, total {cold_s:.3f} s, peak device '
            f'memory {peak_gb:.2f} GB; kernel launches '
            f'{launches["table6_sweep"]}, {metal_launches(seen, "F")} of '
            'F_0 from the metal stack at ' + '; '.join(
                layout_label(k[0], k[1], k[2:]) for k in seen))
        checks += check_launches(device, 'table6_sweep', layouts)
        if stats['source'] != 'sweep' or not Path(
                stats['cache_path']).exists():
            fail(f'table6 cold build: source {stats["source"]}, no cache '
                 'entry written')
        if spec.degrees != (32, 32, 12, 12) or spec.names != (
                'ap', 'at', 'drp_QSO', 'sigma_velo_disp_lorentz_QSO'):
            fail(f'table6: the grid is {spec}')
        want_components = [(tuple(d), c) for d, c in
                           reference['components']]
        if components != want_components or swept != \
                reference['swept_nodes']:
            fail(f'table6: {len(components)} components / {swept} nodes, '
                 f'the reference {len(want_components)} / '
                 f'{reference["swept_nodes"]}')
        if not launches['table6_sweep'].get(('F', 0)) \
                or not metal_launches(seen, 'F'):
            fail('the table6 sweep launched no F_0 (or none from metals.py)')
        on_card = {t.device.type for corr in vega._device_collapsed(
            payload).values() if isinstance(corr, dict)
            for t in corr.values()}
        if vega.device.type != 'cuda' or on_card != {'cuda'}:
            fail(f'table6: the interface is on {vega.device}, the served '
                 f'payload on {on_card}')
        budget = PROBE_BUDGETS * float(os.environ.get(
            'VEGA_TPU_GRID_MODE_BUDGET', 2e-4))
        probe_misses = {}
        for name in vega.corr_items:
            if name not in payload:
                fail(f'table6: {name} is not served by the grid payload')
            p = payload[name]
            probe = float(p['probe_err'])
            if probe > budget:
                probe_misses[name] = probe
            log(f'  {name}: T = {p["cref"].shape[0]}, retained modes A '
                f'{p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
                f'SVD rank A {p["B_A"].shape[1]} / sy '
                f'{p["B_sy"].shape[1]}, dc_max {float(p["dc_max"]):.6g}, '
                f'probe_err {probe:.6g} (vega_tpu warns above {budget:g})')
        if probe_misses:
            log(f'table6 STANDING DEPARTURE (node convergence on the '
                f'synthetic data, ROADMAP.md section 3): probe_err above '
                f'{budget:g} for {probe_misses}')

        # --- the warm build: loads from the cache, launches nothing
        warm = VegaInterface(main_ini, device=device)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        warm.get_collapsed(frozenset(names))
        warm_s = time.perf_counter() - t0
        warm_launches = sum(LAUNCHES.values())
        got_cold = vega.chi2_batch(points)
        got_warm = warm.chi2_batch(points)
        log(f'table6 warm build: source {warm.grid_stats["source"]}, chi^2 '
            f'constants {warm.grid_stats["constants_s"]:.3f} s, fingerprint '
            f'{warm.grid_stats["fingerprint_s"]:.3f} s, load '
            f'{warm.grid_stats.get("load_s", float("nan")):.3f} s, '
            f'get_collapsed {warm_s:.3f} s, {warm_launches} kernel '
            f'launches; chi2_batch at the {len(points["ap"])} points '
            f'bit-equal to the cold interface\'s '
            f'{torch.equal(got_cold, got_warm)}')
        if warm.grid_stats['source'] != 'disk' or warm_launches:
            fail('table6 warm build did not load the payload without a '
                 'kernel launch')
        if not torch.equal(got_cold, got_warm):
            fail('table6 warm chi2_batch differs from the cold one')
        del warm

    # --- the served chi^2 against vega_tpu's dense chi^2
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(main_ini, device=device)
    dense_want = np.asarray(goldens['chi2_dense'])
    got = dense_vega.chi2_batch(points).cpu().numpy()
    rel = float(np.max(np.abs(got - dense_want) / np.abs(dense_want)))
    grads = []
    for i, want in enumerate(goldens['gradients']):
        value, grad = dense_vega.chi2_value_and_gradient(
            {n: points[n][i] for n in names})
        g = np.array([grad[n] for n in names])
        grads.append(max(abs(value / want['chi2'] - 1), float(
            np.max(np.abs(g - want['gradient']))
            / np.max(np.abs(want['gradient'])))))
    log(f'table6 dense vs JAX goldens: chi2 max relative diff {rel:.3e}; '
        f'value and gradient at {len(grads)} points {max(grads):.3e}')
    if not rel <= GOLDEN_RTOL or not max(grads) <= GOLDEN_RTOL:
        fail(f'table6 dense chi2 / gradient vs the JAX goldens differ by '
             f'{rel:.3e} / {max(grads):.3e} > {GOLDEN_RTOL}')
    grid = got_cold.cpu().numpy()
    d_grid = np.abs(grid - dense_want)
    bound = TABLE6_DENSE_ABS + TABLE6_DENSE_REL * np.abs(dense_want)
    within = bool(np.all(d_grid <= bound))
    log(f'table6 grid vs JAX dense goldens ({len(grid)} points, chi2 '
        f'{dense_want.min():.6g} .. {dense_want.max():.6g}): |d chi2| '
        + ', '.join(f'{d:.6g}' for d in d_grid)
        + f' (relative {np.max(d_grid / np.abs(dense_want)):.3e}); gate '
        f'{TABLE6_DENSE_ABS:g} + {TABLE6_DENSE_REL:g} |chi2|: '
        + ('within' if within else 'MISSED'))
    if not within:
        log('table6 STANDING DEPARTURE (node convergence on the synthetic '
            'data, ROADMAP.md section 3): the grid payload misses the '
            'dense chi^2 by more than the gate')

    rng = np.random.default_rng(0)
    rates, batches = {}, {}
    for n_rows in GRID_BATCHES:
        rows = batches[n_rows] = {
            n: vega.params[n] + 0.01 * max(abs(vega.params[n]), 0.1)
            * rng.normal(size=n_rows) for n in names}
        chi2 = vega.chi2_batch(rows).cpu().numpy()
        if not np.all(np.isfinite(chi2)) or np.any(chi2 >= 1e100):
            fail(f'table6 grid chi2_batch({n_rows}) is not finite')
        per_round = []
        for _ in range(GRID_ROUNDS):
            for name in rows:
                rows[name] = rows[name] + 1e-9
            t0 = time.perf_counter()
            vega.chi2_batch(rows).cpu()
            per_round.append(n_rows / (time.perf_counter() - t0))
        rates[n_rows] = float(np.median(per_round))
        log(f'table6 grid chi2_batch({n_rows}), 13 names: '
            f'{rates[n_rows]:.1f} evals/s (median of {GRID_ROUNDS}; per '
            f'round {", ".join(f"{r:.1f}" for r in per_round)})')
    log(json.dumps({
        'metric': 'likelihood evals/sec/chip',
        'value': round(rates[BATCH], 3),
        'unit': f'evals/s/chip (synthetic-dr16-table6-full, 13 names, '
                f'batch={BATCH}, f64, 1 chip(s), {card}, vega_tpu_torch, '
                f'cold build={cold_s:.1f}s, warm load={warm_s:.2f}s; batch '
                f'{GRID_BATCHES[1]}: {rates[GRID_BATCHES[1]]:.1f})'}))
    profile_call(f'table6 grid chi2_batch({BATCH})',
                 lambda: vega.chi2_batch(batches[BATCH]).cpu(), device)

    # --- the fit on the payload and its results file
    seconds, counts = timed_fit(device, vega, 'table6 grid')
    best = vega.bestfit
    if not (best.fmin.is_valid and not best.fmin.hesse_failed):
        fail('table6 grid fit is not valid')
    log(f'table6 grid fit: {seconds:.3f} s, fval {best.fmin.fval!r} (the '
        f'dense chi^2 there {dense_vega.chi2(best.values)!r}), values '
        f'{best.values}')
    del dense_vega
    table6_results_file(vega, work)
    table6_mc_scripts(work, fit_ini)
    log(f'table6 phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# ----------------------------------------------------------------------
# eBOSS DR16 as published: four correlations, old_fftlog, old_growth_func,
# binsize, the sky-residual broadband, 18 sampled names
# ----------------------------------------------------------------------
def dr16pub_shares(device, vega, batches):
    """Device ms of one dense chi2_batch(batches) and of its parts: the
    power-spectrum grids, the core transforms (the legacy GEMMs and the
    core's combine), every combine (core and metal stacks), the metal
    stacks (their own transforms and combines included) and the
    broadband (CUDA events around each call)."""
    from vega_tpu_torch import metals as metals_mod
    from vega_tpu_torch import pktoxi as pktoxi_mod
    models = list(vega.models.values())
    hooks = {
        'pk': [(m.Pk_core, 'compute_peak_smooth') for m in models],
        'transform': [(m.PktoXi, 'compute') for m in models],
        'core_combine': [(pktoxi_mod, 'spline_legendre_combine')],
        'metal_combine': [(metals_mod, 'spline_legendre_combine')],
        'metals': [(m.metals, 'compute') for m in models],
        'broadband': [(m.broadband, 'compute') for m in models
                      if m.broadband is not None]}
    total, parts = device_shares(device, vega, batches, hooks)
    gemms = parts['transform'] - parts['core_combine']
    combine = parts['core_combine'] + parts['metal_combine']
    named = {'power-spectrum grids': parts['pk'],
             'legacy transform GEMMs (core)': gemms,
             'combine (core and metals)': combine,
             'metal stacks (their GEMMs and combines included)':
                 parts['metals'],
             'broadband': parts['broadband']}
    rest = total - parts['pk'] - parts['transform'] - parts['metals'] \
        - parts['broadband']
    log(f'dr16pub dense chi2_batch({BATCH}) on CUDA events: {total:.1f} ms; '
        + ', '.join(f'{k} {v:.1f} ms ({v / total:.1%})'
                    for k, v in named.items())
        + f'; the rest (chi^2, z evolution, masks) {rest:.1f} ms')
    return total, named


def run_dr16pub_path(device, work, card):
    """Phase dr16pub (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import make_dr16_published_dataset
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(DR16PUB_GOLDENS.read_text())
    names = goldens['names']
    t_phase = time.perf_counter()
    main_ini = make_dr16_published_dataset(Path(work) / 'dr16pub',
                                           size='full', device=device)
    log(f'dr16pub: configuration synthetic-dr16-published-full in '
        f'{time.perf_counter() - t_phase:.2f} s')
    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(main_ini, device=device)
    if sorted(dense_vega.sample_params['limits']) != sorted(names):
        fail(f'dr16pub samples {sorted(dense_vega.sample_params["limits"])}')
    log(f'dr16pub dense: interface in {time.perf_counter() - t0:.2f} s; '
        'metal pairs ' + ', '.join(
            f'{n} {len(item.metal_correlations)} in '
            f'{len(dense_vega.models[n].metals._stacked_plans)} classes'
            for n, item in dense_vega.corr_items.items())
        + '; knots ' + ', '.join(
            f'{n} [{m.PktoXi.logr_knots[0]:.6f}, '
            f'{m.PktoXi.logr_knots[-1]:.6f}] (old_fftlog '
            f'{m.PktoXi.old_fftlog})' for n, m in dense_vega.models.items()))
    truth = {n: dense_vega.params[n] for n in names}
    rng = np.random.default_rng(0)
    batches = {n: truth[n] + 0.01 * (abs(truth[n]) or 0.1)
               * rng.normal(size=BATCH) for n in names}
    launches, checks = {}, []

    # --- the dense regime: counts from zero
    seen = watch_metals(dense_vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        chi2_truth = dense_vega.chi2(truth)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = dense_vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches['dr16pub_dense'] = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    checks += check_launches(device, 'dr16pub_dense', layouts)
    prior = dense_vega.compute_prior_chi2(truth)
    if not abs(chi2_truth - prior) < DEFAULT_CHI2_MAX:
        fail(f'dr16pub chi2 at the truth {chi2_truth!r}, its priors\' '
             f'{prior!r}')
    chi2_np = chi2.cpu().numpy()
    if chi2_np.shape != (BATCH,) or not np.all(np.isfinite(chi2_np)) \
            or np.any(chi2_np >= 1e100):
        fail('dr16pub dense chi2_batch is not finite of shape (8192,) '
             'without a penalty')
    n_metal = metal_launches(seen, 'F')
    log(f'dr16pub dense chi2_batch({BATCH}), {len(names)} names: chi2 at '
        f'the truth {chi2_truth!r} (the priors\' {prior!r}), first call '
        f'{first_s:.3f} s, peak device memory {peak_gb:.2f} GB, chi2 in '
        f'[{chi2_np.min():.6g}, {chi2_np.max():.6g}], kernel launches '
        f'{launches["dr16pub_dense"]}, {n_metal} of F_0 from the metal '
        'stacks at ' + '; '.join(layout_label(k[0], k[1], k[2:])
                                 for k in seen))
    if not n_metal:
        fail('the dr16pub dense path launched no F_0 from metals.py')
    plain = dense_vega.chi2_batch(batches, use_kernel=False).cpu().numpy()
    rel = float(np.max(np.abs(plain - chi2_np) / np.abs(plain)))
    log(f'dr16pub dense kernel path vs plain path: max relative diff '
        f'{rel:.3e}')
    if not rel <= PLAIN_RTOL:
        fail(f'dr16pub kernel path vs plain path differ by {rel:.3e}')
    dense_want = np.asarray(goldens['chi2_dense'])
    got = dense_vega.chi2_batch(goldens['points']).cpu().numpy()
    rel = float(np.max(np.abs(got - dense_want) / np.abs(dense_want)))
    deriv = goldens['derivatives']
    grads = []
    for point, value_w, grad_w in zip(deriv['points'], deriv['chi2'],
                                      deriv['gradient']):
        value, grad = dense_vega.chi2_value_and_gradient(point)
        g = np.array([grad[n] for n in names])
        grads.append(max(abs(value / value_w - 1), float(
            np.max(np.abs(g - grad_w)) / np.max(np.abs(grad_w)))))
    log(f'dr16pub dense vs JAX goldens: chi2 at {len(dense_want)} points '
        f'max relative diff {rel:.3e}; value and gradient at {len(grads)} '
        f'points {max(grads):.3e}')
    if not rel <= GOLDEN_RTOL or not max(grads) <= GOLDEN_RTOL:
        fail(f'dr16pub dense chi2 / gradient vs the JAX goldens differ by '
             f'{rel:.3e} / {max(grads):.3e} > {GOLDEN_RTOL}')
    times = []
    for _ in range(TIMED_ROUNDS):
        for name in batches:
            batches[name] = batches[name] + 1e-9
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dense_vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    dense_rate = BATCH / float(np.median(times))
    log(f'dr16pub dense chi2_batch({BATCH}): {dense_rate:.1f} evals/s '
        f'(median of {TIMED_ROUNDS}, s per call '
        f'{", ".join(f"{t:.4f}" for t in times)})')
    dr16pub_shares(device, dense_vega, batches)

    # --- vega_tpu's route for the 18 names: counts from zero
    cache_dir = Path(work) / 'grid_cache_dr16pub'
    with switch('VEGA_TPU_GRID_CACHE', None), \
            switch('VEGA_TPU_GRID_CACHE_DIR', str(cache_dir)), \
            switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        vega = VegaInterface(main_ini, device=device)
        seen_grid = watch_metals(vega)
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            payload = vega.get_collapsed(frozenset(names))
            torch.cuda.synchronize(device)
            cold_s = time.perf_counter() - t0
        launches['dr16pub_sweep'] = dict(LAUNCHES)
        checks += check_launches(device, 'dr16pub_sweep', layouts)
        stats = vega.grid_stats
        spec = payload['__grid__']
        log(f'dr16pub cold build: {spec}, {stats["nodes"]} swept nodes '
            f'and probes; chi^2 constants {stats["constants_s"]:.3f} s, '
            f'device sweep {stats["sweep_s"]:.3f} s, host payload build '
            f'{stats["host_s"]:.3f} s, total {cold_s:.3f} s, peak device '
            f'memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} '
            f'GB; kernel launches {launches["dr16pub_sweep"]}, '
            f'{metal_launches(seen_grid, "F")} of F_0 from the metal '
            'stacks at ' + '; '.join(layout_label(k[0], k[1], k[2:])
                                     for k in seen_grid))
        served = set(payload) - {'__grid__'}
        if served != {'lyaxqso', 'lybxqso'} or spec.names != (
                'ap', 'at', 'drp_QSO', 'sigma_velo_disp_lorentz_QSO'):
            fail(f'dr16pub: the payload serves {sorted(served)} over {spec}, '
                 'vega_tpu\'s route the crosses over (ap, at, drp_QSO, '
                 'sigma_velo_disp_lorentz_QSO)')
        if stats['source'] != 'sweep' or not metal_launches(seen_grid, 'F'):
            fail('dr16pub: no cold sweep, or no F_0 from the metal stacks '
                 'in it')
        for name in sorted(served):
            p = payload[name]
            log(f'  {name}: T = {p["cref"].shape[0]}, kept modes A '
                f'{p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
                f'SVD rank A {p["B_A"].shape[1]} / sy {p["B_sy"].shape[1]}, '
                f'dc_max {float(p["dc_max"]):.6g}, probe_err '
                f'{float(p["probe_err"]):.6g}')
        log('  lyaxlya, lyaxlyb: evaluated densely at the true values (the '
            'sky terms read sampled names), as vega_tpu evaluates them')

        LAUNCHES.clear()
        with recorded_launches() as layouts:
            chi2 = vega.chi2_batch(batches).cpu().numpy()
        launches['dr16pub_grid'] = dict(LAUNCHES)
        checks += check_launches(device, 'dr16pub_grid', layouts)
        if not np.all(np.isfinite(chi2)) or np.any(chi2 >= 1e100):
            fail('dr16pub grid-route chi2_batch is not finite')
        rates = {}
        for n_rows in GRID_BATCHES:
            rows = {n: truth[n] + 0.01 * (abs(truth[n]) or 0.1)
                    * rng.normal(size=n_rows) for n in names}
            vega.chi2_batch(rows).cpu()
            per_round = []
            for _ in range(TIMED_ROUNDS):
                for name in rows:
                    rows[name] = rows[name] + 1e-9
                t0 = time.perf_counter()
                vega.chi2_batch(rows).cpu()
                per_round.append(n_rows / (time.perf_counter() - t0))
            rates[n_rows] = float(np.median(per_round))
            log(f'dr16pub grid-route chi2_batch({n_rows}), {len(names)} '
                f'names: {rates[n_rows]:.1f} evals/s (median of '
                f'{TIMED_ROUNDS}; per round '
                f'{", ".join(f"{r:.1f}" for r in per_round)})')
        log(json.dumps({
            'metric': 'likelihood evals/sec/chip',
            'value': round(rates[BATCH], 3),
            'unit': f'evals/s/chip (synthetic-dr16-published-full, '
                    f'{len(names)} names, vega_tpu\'s route: crosses from '
                    f'the payload, autos dense, batch={BATCH}, f64, 1 '
                    f'chip(s), {card}, vega_tpu_torch, cold build='
                    f'{cold_s:.1f}s; batch {GRID_BATCHES[1]}: '
                    f'{rates[GRID_BATCHES[1]]:.1f}; dense: '
                    f'{dense_rate:.1f})'}))
        profile_call(f'dr16pub grid-route chi2_batch({BATCH})',
                     lambda: vega.chi2_batch(batches).cpu(), device)
        grid = vega.chi2_batch(goldens['points']).cpu().numpy()
        d_grid = grid - dense_want
        log(f'dr16pub grid route vs JAX dense goldens ({len(grid)} points, '
            f'chi2 {dense_want.min():.6g} .. {dense_want.max():.6g}): '
            f'd chi2 ' + ', '.join(f'{d:.6g}' for d in d_grid)
            + f' (relative {np.max(np.abs(d_grid) / dense_want):.3e}); '
            'reported, not enforced (the sigma_velo node convergence of '
            'ROADMAP.md section 3)')

        # --- the warm build: loads from the cache, launches nothing
        warm = VegaInterface(main_ini, device=device)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        warm.get_collapsed(frozenset(names))
        warm_s = time.perf_counter() - t0
        warm_launches = sum(LAUNCHES.values())
        same = torch.equal(warm.chi2_batch(goldens['points']),
                           torch.as_tensor(grid, device=device))
        log(f'dr16pub warm build: source {warm.grid_stats["source"]}, '
            f'get_collapsed {warm_s:.3f} s, {warm_launches} kernel launches '
            f'in it; chi2_batch at the golden points bit-equal to the cold '
            f'interface\'s {same}')
        if warm.grid_stats['source'] != 'disk' or warm_launches or not same:
            fail('dr16pub warm build did not load the payload without a '
                 'kernel launch, or serves another chi^2')
        del warm

    # --- the fit in vega_tpu's route (the dense fit is run_vega's)
    seconds, counts = timed_fit(device, vega, 'dr16pub grid route')
    best = vega.bestfit
    want = goldens['fit_dense']
    d_sigma = max(abs(best.values[n] - v) / e for n, v, e in
                  zip(names, want['values'], want['errors']))
    log(f'dr16pub grid-route fit: fval {best.fmin.fval!r}, valid '
        f'{best.fmin.is_valid}; the dense chi^2 at its best fit '
        f'{dense_vega.chi2(best.values)!r} (the JAX dense fit\'s '
        f'{want["fval"]!r}); max |d value| from the JAX dense fit '
        f'{d_sigma:.3e} errors; reported, not enforced')
    log(f'dr16pub phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# ----------------------------------------------------------------------
# A fit from the command line: run_vega on DR16 as published
# ----------------------------------------------------------------------
def held_to_summary(got, want):
    """max |got - want| over want's indices, of max|want|, and the norms'
    relative difference: got the full vector, want the goldens' summary
    (tests/tools/make_torch_port_run_vega_goldens.py::summary)."""
    got = np.asarray(got, dtype=float).ravel()
    if got.size != want['size']:
        fail(f'a vector of {got.size} entries against {want["size"]}')
    scale = want['max_abs'] or 1.0
    err = float(np.max(np.abs(got[want['index']] - want['values']))) / scale
    norm = abs(float(np.linalg.norm(got)) - want['norm']) / (
        want['norm'] or 1.0)
    return max(err, norm)


def check_sensitivity(label, vega, want, rtol):
    """vega.sensitivity against the goldens' partials and Fisher sums:
    returns the worst partial and the worst sum (of its bins' absolute
    sum); fails above rtol."""
    worst_partial = worst_fisher = 0.
    for corr, partials in want['partials'].items():
        got = vega.sensitivity['partials'][corr]
        if sorted(got) != sorted(partials):
            fail(f'{label}: {corr} has partials in {sorted(got)}')
        for name, summ in partials.items():
            worst_partial = max(worst_partial, held_to_summary(got[name],
                                                               summ))
        fisher = {'|'.join(k): v
                  for k, v in vega.sensitivity['fisher'][corr].items()}
        if sorted(fisher) != sorted(want['fisher_sums'][corr]):
            fail(f'{label}: {corr} has Fisher pairs {sorted(fisher)}')
        for key, sums in want['fisher_sums'][corr].items():
            scale = np.asarray(want['fisher_abs_sums'][corr][key])
            diff = np.abs(np.nansum(fisher[key], axis=1) - sums)
            worst_fisher = max(worst_fisher,
                               float(np.max(diff / np.maximum(scale, 1e-300))))
    log(f'{label} vs the JAX goldens: partials max diff {worst_partial:.3e} '
        f'of max|ref|, Fisher sums {worst_fisher:.3e} of their bins\' '
        f'absolute sum')
    if not max(worst_partial, worst_fisher) <= rtol:
        fail(f'{label} differs from the JAX goldens by {worst_partial:.3e} '
             f'/ {worst_fisher:.3e} > {rtol:g}')


def check_results_hdus(label, hdus, vega):
    """The results file's MODEL_* models and BESTFIT (names, values,
    errors, covariance) against the interface's best fit and minimizer,
    bit for bit; fails on any difference."""
    for corr, model in vega.bestfit_model.items():
        if not np.array_equal(hdus[f'MODEL_{corr}'][f'{corr}_MODEL'],
                              np.asarray(model)):
            fail(f'{label}: MODEL_{corr} is not the in-memory best-fit '
                 'model')
    minimizer, best = vega.minimizer, hdus['BESTFIT']
    names = list(minimizer.values)
    if [str(n) for n in best['names']] != names:
        fail(f'{label}: BESTFIT names {list(best["names"])}, the fit\'s '
             f'{names}')
    for column, want in (
            ('values', [minimizer.values[n] for n in names]),
            ('errors', [minimizer.errors[n] for n in names]),
            ('covariance', np.asarray(minimizer.covariance))):
        if not np.array_equal(best[column], np.asarray(want, dtype=float)):
            fail(f'{label}: BESTFIT {column} is not the minimizer\'s')


def component_summaries(model):
    """Every saved component of one correlation's model, the metal
    pairs' own (model.metals) beside the model's, keyed as
    tests/tools/make_torch_port_run_vega_goldens.py keys them."""
    def key_of(key):
        return key if key == 'core' else '|'.join(key)

    got = {}
    for prefix, owner in (('', model), ('metals/', model.metals)):
        if owner is None:
            continue
        for comp in ('pk', 'xi', 'xi_distorted'):
            for part in ('peak', 'smooth', 'full'):
                for key, value in getattr(owner, comp)[part].items():
                    got[f'{prefix}{comp}/{part}/{key_of(key)}'] = value
    return got


def run_run_vega_path(device, work, card):
    """Phase run_vega (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
    import importlib.util

    from vega_tpu_torch import cli
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.scripts import run_vega
    from vega_tpu_torch.testing import make_dr16_published_dataset

    goldens = json.loads(RUN_VEGA_GOLDENS.read_text())
    fit_goldens = json.loads(DR16PUB_GOLDENS.read_text())
    names = goldens['names']
    t_phase = time.perf_counter()
    main_ini = make_dr16_published_dataset(
        Path(work) / 'run_vega', size='full', device=device, components=True,
        files_from=Path(work) / 'dr16pub')
    log(f'run_vega: configuration synthetic-dr16-published-full with the '
        f'components written, on phase dr16pub\'s files, in '
        f'{time.perf_counter() - t_phase:.2f} s')
    plots = importlib.util.find_spec('matplotlib') is not None
    log('run_vega: matplotlib ' + ('is installed: the plots are drawn'
                                   if plots else 'is not installed: no '
                                   'plots'))
    launches, checks = {}, []

    # --- fit and write from the command line: counts from zero
    interfaces = []
    fit_and_write = run_vega.fit_and_write

    def keep(*args, **kwargs):
        interfaces.append(fit_and_write(*args, **kwargs))
        return interfaces[-1]

    run_vega.fit_and_write = keep
    try:
        with switch('VEGA_TPU_GRID_CACHE', None), \
                switch('VEGA_TPU_GRID_CACHE_DIR',
                       str(Path(work) / 'grid_cache_run_vega')):
            LAUNCHES.clear()
            torch.cuda.reset_peak_memory_stats(device)
            with recorded_launches() as layouts:
                t0 = time.perf_counter()
                status = cli.main(['fit', str(main_ini), '--device',
                                   str(device)])
                torch.cuda.synchronize(device)
                fit_s = time.perf_counter() - t0
    finally:
        run_vega.fit_and_write = fit_and_write
    launches['run_vega_fit'] = dict(LAUNCHES)
    vega = interfaces[0]
    log(f'run_vega: cli fit {fit_s:.2f} s (interface, route sweep, fit, '
        f'results file{", plots" if plots else ""}), exit {status}, peak '
        f'device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f}'
        f' GB, route {vega.grid_stats.get("source")} (sweep '
        f'{vega.grid_stats.get("sweep_s", float("nan")):.2f} s, served '
        f'{sorted(set(vega.get_collapsed(frozenset(names))) - {"__grid__"})}'
        f'), kernel launches {launches["run_vega_fit"]}')
    checks += check_launches(device, 'run_vega_fit', layouts)
    if status != 0 or not launches['run_vega_fit'].get(('F', 0)):
        fail('run_vega: the fit exited non-zero or launched no F_0')
    check_fit('run_vega', 'published', vega, names,
              fit_goldens['fit_dense'])

    # --- the results file read back
    path = vega.output.outfile + '.fits'
    hdus = {h.name: h for h in read_fits(path) if getattr(h, 'name', '')}
    want_hdus = {'BESTFIT'} | {f'{kind}_{corr}' for corr in vega.corr_items
                               for kind in ('MODEL', 'PK', 'Xi')}
    if not want_hdus <= set(hdus):
        fail(f'run_vega: {path} holds {sorted(hdus)}')
    check_results_hdus('run_vega', hdus, vega)
    worst_sum = 0.
    for corr, model in vega.models.items():
        for hdu, columns in (
                (f'PK_{corr}', vega.output._get_components(model.pk)),
                (f'Xi_{corr}', vega.output._cf_hdu(corr, model)['columns'])):
            for column, value in columns.items():
                if not np.array_equal(hdus[hdu][column], value):
                    fail(f'run_vega: {hdu} {column} is not the in-memory '
                         'component')
        combined = (vega.params['bao_amp']
                    * model.xi_distorted['peak']['core']
                    + model.xi_distorted['smooth']['core'])
        want = vega.bestfit_model[corr]
        worst_sum = max(worst_sum, float(np.max(np.abs(combined - want))
                                         / np.max(np.abs(want))))
    log(f'run_vega: {path} ({os.path.getsize(path) / 1e6:.1f} MB) holds '
        f'{sorted(hdus)}; every MODEL_ column, BESTFIT\'s names, values, '
        f'errors and covariance and every PK_ / Xi_ column equal to the '
        f'in-memory fit and components; bao_amp x peak + smooth against '
        f'the best-fit model '
        f'{worst_sum:.3e} of max|model|')
    if not worst_sum <= COMPONENT_SUM_RTOL:
        fail(f'run_vega: bao_amp x peak + smooth misses the model by '
             f'{worst_sum:.3e}')
    if plots:
        out_base = vega.output.outfile
        pngs = [Path(f'{out_base}_{corr}_{kind}.png')
                for corr in vega.corr_items for kind in ('wedges', 'shells')]
        if not all(png.exists() for png in pngs):
            fail('run_vega: a wedge or shell plot is missing')
        log(f'run_vega: {len(pngs)} plots written')

    # --- the components at the goldens' point
    t0 = time.perf_counter()
    model_cf = vega.compute_model(goldens['point'], run_init=False)
    worst = 0.
    for corr, model in vega.models.items():
        want = goldens['components'][corr]
        got = component_summaries(model)
        got['model'] = model_cf[corr]
        if sorted(got) != sorted(want):
            fail(f'run_vega: {corr} saves {sorted(got)}, vega_tpu '
                 f'{sorted(want)}')
        for key, summ in want.items():
            worst = max(worst, held_to_summary(got[key], summ))
    log(f'run_vega: components at the goldens\' point against the JAX '
        f'goldens {worst:.3e} of max|ref| ({time.perf_counter() - t0:.2f} '
        's)')
    if not worst <= COMPONENT_RTOL:
        fail(f'run_vega: components differ from the JAX goldens by '
             f'{worst:.3e} > {COMPONENT_RTOL:g}')

    # --- Fisher sensitivity at the goldens' nominal: counts from zero
    nominal = {n: tuple(v) for n, v in goldens['nominal'].items()}
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats(device)
    with recorded_launches() as layouts:
        t0 = time.perf_counter()
        vega.compute_sensitivity_exact(nominal=nominal, verbose=False)
        torch.cuda.synchronize(device)
        exact_s = time.perf_counter() - t0
    launches['run_vega_sensitivity_exact'] = dict(LAUNCHES)
    counts = launches['run_vega_sensitivity_exact']
    log(f'run_vega: compute_sensitivity_exact over {len(nominal)} names '
        f'{exact_s:.2f} s, peak device memory '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB, kernel '
        f'launches {counts}')
    if not (counts.get(('F', 0))
            and any(n for (p, d), n in counts.items()
                    if p in ('F', 'P') and d >= 1)
            and any(n for (p, _), n in counts.items() if p == 'Ft')):
        fail('run_vega: the exact Jacobian did not launch F_0, a kernel of '
             'order d >= 1 and the transpose')
    checks += check_launches(device, 'run_vega_sensitivity_exact', layouts)
    check_sensitivity('run_vega compute_sensitivity_exact', vega,
                      goldens['exact'], SENSITIVITY_EXACT_RTOL)

    # the other sampled names at the goldens' point, not the run's fit
    vega.params.update(goldens['point'])
    fd_nominal = {n: nominal[n] for n in goldens['fd_names']}
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        t0 = time.perf_counter()
        vega.compute_sensitivity(nominal=fd_nominal, verbose=False)
        torch.cuda.synchronize(device)
        fd_s = time.perf_counter() - t0
    launches['run_vega_sensitivity_fd'] = dict(LAUNCHES)
    log(f'run_vega: compute_sensitivity over {list(fd_nominal)} '
        f'({2 * len(fd_nominal)} rebuilds) {fd_s:.2f} s, kernel launches '
        f'{launches["run_vega_sensitivity_fd"]}')
    checks += check_launches(device, 'run_vega_sensitivity_fd', layouts)
    check_sensitivity('run_vega compute_sensitivity', vega, goldens['fd'],
                      SENSITIVITY_FD_RTOL)
    log(f'run_vega phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# ----------------------------------------------------------------------
# The mock configurations: DESI DR1 as run on mocks, LyaCoLoRe
# ----------------------------------------------------------------------
def mock_dense_regime(device, label, vega, goldens, launches, checks,
                      hooks):
    """The dense regime of a mock phase, counts from zero: chi^2 at the
    defaults, chi2_batch(8192) (finite; kernel vs plain route
    PLAIN_RTOL), the JAX goldens' chi^2 at their points and value and
    gradient at theirs (GOLDEN_RTOL), evals/s and the device shares of
    `hooks` ({key: [(owner, attribute)]}). Returns the rate."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    names = goldens['names']
    rng = np.random.default_rng(0)
    batches = desi_rows(vega.params, names, BATCH, rng)
    seen = watch_metals(vega) if any(
        m.metals is not None for m in vega.models.values()) else {}
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        chi2_default = vega.chi2()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches[f'{label}_dense'] = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    checks += check_launches(device, f'{label}_dense', layouts)
    d_default = abs(chi2_default - goldens['chi2_default'])
    if not d_default <= GOLDEN_RTOL * max(abs(goldens['chi2_default']),
                                          1.0):
        fail(f'{label} chi2 at the defaults {chi2_default!r}, the JAX '
             f'package {goldens["chi2_default"]!r}')
    chi2_np = chi2.cpu().numpy()
    if chi2_np.shape != (BATCH,) or not np.all(np.isfinite(chi2_np)) \
            or np.any(chi2_np >= 1e100):
        fail(f'{label} dense chi2_batch is not finite of shape (8192,) '
             'without a penalty')
    log(f'{label} dense chi2_batch({BATCH}), {len(names)} names: chi2 at '
        f'the defaults {chi2_default!r} (JAX {goldens["chi2_default"]!r}), '
        f'first call {first_s:.3f} s, peak device memory {peak_gb:.2f} GB, '
        f'chi2 in [{chi2_np.min():.6g}, {chi2_np.max():.6g}], kernel '
        f'launches {launches[f"{label}_dense"]}'
        + (f', {metal_launches(seen, "F")} of F_0 from the metal stacks at '
           + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen)
           if seen else ''))
    if seen and not metal_launches(seen, 'F'):
        fail(f'the {label} dense path launched no F_0 from metals.py')
    plain = vega.chi2_batch(batches, use_kernel=False).cpu().numpy()
    rel = float(np.max(np.abs(plain - chi2_np) / np.abs(plain)))
    log(f'{label} dense kernel path vs plain path: max relative diff '
        f'{rel:.3e}')
    if not rel <= PLAIN_RTOL:
        fail(f'{label} kernel path vs plain path differ by {rel:.3e}')
    want = np.asarray(goldens['chi2_dense'])
    got = vega.chi2_batch(goldens['params']).cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    deriv = goldens['dense']
    grads = []
    for point, value_w, grad_w in zip(goldens['derivative_points'],
                                      deriv['chi2'], deriv['gradient']):
        value, grad = vega.chi2_value_and_gradient(point)
        g = np.array([grad[n] for n in names])
        grads.append(max(abs(value / value_w - 1), rel_err(g, grad_w)))
    log(f'{label} dense vs JAX goldens: chi2 at {len(want)} points max '
        f'relative diff {rel:.3e}; value and gradient at {len(grads)} '
        f'points {max(grads):.3e}')
    if not rel <= GOLDEN_RTOL or not max(grads) <= GOLDEN_RTOL:
        fail(f'{label} dense chi2 / gradient vs the JAX goldens differ by '
             f'{rel:.3e} / {max(grads):.3e} > {GOLDEN_RTOL}')
    times = []
    for _ in range(DESI_TIMED_ROUNDS):
        for name in batches:
            batches[name] = batches[name] + 1e-9
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    rate = BATCH / float(np.median(times))
    log(f'{label} dense chi2_batch({BATCH}): {rate:.1f} evals/s (median of '
        f'{DESI_TIMED_ROUNDS}, s per call '
        f'{", ".join(f"{t:.4f}" for t in times)})')
    total_ms, parts = device_shares(device, vega, batches, hooks=hooks)
    log(f'{label} dense chi2_batch({BATCH}) on CUDA events: {total_ms:.1f} '
        'ms; ' + ', '.join(f'{key} {ms:.1f} ms ({ms / total_ms:.1%})'
                           for key, ms in parts.items())
        + f'; the rest (transform, core combine, chi^2) '
        f'{total_ms - sum(parts.values()):.1f} ms')
    profile_call(f'{label} dense chi2_batch({BATCH})',
                 lambda: vega.chi2_batch(batches).cpu(), device)
    return rate


def run_desi_mock_path(device, work, card):
    """Phase desi_mock (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
    import vega_tpu_torch.metals as metals_mod
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import (DESI_MOCK_FIT_SAMPLE,
                                        make_desi_mock_dataset, with_sample)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(MOCKS_GOLDENS.read_text())['desi_mock']
    names, grid_names = goldens['names'], goldens['grid_names']
    t_phase = time.perf_counter()
    main_ini = make_desi_mock_dataset(Path(work) / 'desi_mock', size='full',
                                      device=device,
                                      sample=DESI_MOCK_FIT_SAMPLE)
    log(f'desi_mock: configuration synthetic-desi-mock-full in '
        f'{time.perf_counter() - t_phase:.2f} s')
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(main_ini, device=device)
    if sorted(dense_vega.sample_params['limits']) != sorted(names):
        fail(f'desi_mock samples {sorted(dense_vega.sample_params["limits"])}')
    log('desi_mock dense: new-metals matrices on the host ' + ', '.join(
        f'{n} {len(item.metal_correlations)} pairs '
        f'{dense_vega.models[n].metals.matrix_build_s:.3f} s'
        for n, item in dense_vega.corr_items.items()))
    launches, checks = {}, []
    models = list(dense_vega.models.values())
    mock_dense_regime(device, 'desi_mock', dense_vega, goldens, launches,
                      checks, hooks={
                          'metal matrices': [(m.metals, 'apply_metal_matrix')
                                             for m in models],
                          'metal combine': [(metals_mod,
                                             'spline_legendre_combine')],
                          'power-spectrum grids (smoothing included)': [
                              (m.Pk_core, 'compute_peak_smooth')
                              for m in models]})

    # --- the grid regime: the fixed widths keep both correlations
    # factored; counts from zero
    grid_main = with_sample(main_ini, {n: DESI_MOCK_FIT_SAMPLE[n]
                                       for n in grid_names},
                            Path(main_ini).parent / 'main_grid.ini')
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid_vega = VegaInterface(grid_main, device=device)
    seen_grid = watch_metals(grid_vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        payload = grid_vega.get_collapsed(frozenset(grid_names))
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        rng = np.random.default_rng(1)
        grid_batches = desi_rows(grid_vega.params, grid_names, BATCH, rng)
        chi2 = grid_vega.chi2_batch(grid_batches).cpu().numpy()
    launches['desi_mock_grid'] = dict(LAUNCHES)
    checks += check_launches(device, 'desi_mock_grid', layouts)
    stats = grid_vega.grid_stats
    log(f'desi_mock grid cold build ({len(grid_names)} names): '
        f'{payload["__grid__"]}, {stats["nodes"]} nodes; chi^2 constants '
        f'{stats["constants_s"]:.3f} s, device sweep {stats["sweep_s"]:.3f} '
        f's, host payload build {stats["host_s"]:.3f} s, total '
        f'{collapse_s:.3f} s; kernel launches {launches["desi_mock_grid"]}, '
        f'{metal_launches(seen_grid, "F")} of F_0 from the metal stacks at '
        + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen_grid))
    for name in grid_vega.corr_items:
        if name not in payload:
            fail(f'desi_mock: {name} is not served by the grid payload')
        p, want = payload[name], goldens['payload'][name]
        log(f'  {name}: T = {p["cref"].shape[0]}, retained modes '
            f'A {p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
            f'SVD rank A {p["B_A"].shape[1]} / sy {p["B_sy"].shape[1]} '
            f'(JAX package: T = {want["terms"]}, modes {want["modes_A"]} / '
            f'{want["modes_sy"]}, rank {want["rank_A"]} / '
            f'{want["rank_sy"]}), dc_max {float(p["dc_max"]):.6g}')
        if p['cref'].shape[0] != want['terms']:
            fail(f'desi_mock: {name} has {p["cref"].shape[0]} terms, the '
                 f'JAX package {want["terms"]}')
    if not metal_launches(seen_grid, 'F'):
        fail('the desi_mock grid sweep launched no F_0 from metals.py')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)) \
            or np.any(chi2 >= 1e100):
        fail('desi_mock grid chi2_batch is not finite without a penalty')
    got = grid_vega.chi2_batch({n: goldens['params'][n]
                                for n in grid_names}).cpu().numpy()
    want_grid = np.asarray(goldens['chi2_grid'])
    d_grid = np.abs(got - want_grid)
    bound = GRID_ABS_TOL + GRID_REL_TOL * np.abs(want_grid)
    log(f'desi_mock grid vs JAX grid goldens ({len(got)} points): max |d '
        f'chi2| {d_grid.max():.3e} (bound {bound.min():.3e} .. '
        f'{bound.max():.3e}); vs the JAX dense chi2 '
        f'{np.abs(got - goldens["chi2_grid_dense"]).max():.6g} (the JAX grid '
        f'path\'s own {goldens["max_abs_grid_minus_dense"]:.6g})')
    if not np.all(d_grid <= bound):
        fail(f'desi_mock grid chi2 vs the JAX grid chi2: |d| '
             f'{d_grid.max():.3e} over the bound')
    rates = {}
    for n_rows in GRID_BATCHES:
        rows = desi_rows(grid_vega.params, grid_names, n_rows, rng)
        grid_vega.chi2_batch(rows).cpu()
        per_round = []
        for _ in range(GRID_ROUNDS):
            for name in rows:
                rows[name] = rows[name] + 1e-9
            t0 = time.perf_counter()
            grid_vega.chi2_batch(rows).cpu()
            per_round.append(n_rows / (time.perf_counter() - t0))
        rates[n_rows] = float(np.median(per_round))
        log(f'desi_mock grid chi2_batch({n_rows}): {rates[n_rows]:.1f} '
            f'evals/s (median of {GRID_ROUNDS}; per round '
            f'{", ".join(f"{r:.1f}" for r in per_round)})')
    log(json.dumps({
        'metric': 'likelihood evals/sec/chip',
        'value': round(rates[BATCH], 3),
        'unit': f'evals/s/chip (synthetic-desi-mock-full, {len(grid_names)} '
                f'names, batch={BATCH}, f64, 1 chip(s), {card}, '
                f'vega_tpu_torch, collapse={collapse_s:.1f}s; batch '
                f'{GRID_BATCHES[1]}: {rates[GRID_BATCHES[1]]:.1f})'}))
    profile_call(f'desi_mock grid chi2_batch({BATCH})',
                 lambda: grid_vega.chi2_batch(grid_batches).cpu(), device)
    timed_fit(device, grid_vega, 'desi_mock grid')
    check_fit('desi_mock grid', 'grid', grid_vega, grid_names,
              goldens['fit_grid'])
    log(f'desi_mock phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


def run_lyacolore_path(device, work, card):
    """Phase lyacolore (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
    from vega_tpu_torch import pktoxi as pktoxi_mod
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import (LYACOLORE_FIT_SAMPLE,
                                        make_lyacolore_dataset)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(MOCKS_GOLDENS.read_text())['lyacolore']
    names = goldens['names']
    t_phase = time.perf_counter()
    main_ini = make_lyacolore_dataset(Path(work) / 'lyacolore', size='full',
                                      device=device,
                                      sample=LYACOLORE_FIT_SAMPLE)
    log(f'lyacolore: configuration synthetic-lyacolore-full in '
        f'{time.perf_counter() - t_phase:.2f} s')
    launches, checks = {}, []

    # --- vega_tpu's route for the six names: its sweep over (ap, at)
    # finds the auto dense (the smoothing reads sampled widths), so every
    # call is dense; counts from zero
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        route_vega = VegaInterface(main_ini, device=device)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        t0 = time.perf_counter()
        payload = route_vega.get_collapsed(frozenset(names))
        torch.cuda.synchronize(device)
        sweep_s = time.perf_counter() - t0
        rng = np.random.default_rng(2)
        batches = desi_rows(route_vega.params, names, BATCH, rng)
        route_vega.chi2_batch(batches).cpu()
    launches['lyacolore_route'] = dict(LAUNCHES)
    checks += check_launches(device, 'lyacolore_route', layouts)
    if payload != {}:
        fail(f'lyacolore: the route serves {sorted(payload)}, vega_tpu\'s '
             'route nothing (a dense auto)')
    times = []
    for _ in range(DESI_TIMED_ROUNDS):
        for name in batches:
            batches[name] = batches[name] + 1e-9
        t0 = time.perf_counter()
        route_vega.chi2_batch(batches).cpu()
        times.append(time.perf_counter() - t0)
    log(f'lyacolore route: the sweep over (ap, at) in {sweep_s:.3f} s found '
        f'nothing factored (grid_stats {route_vega.grid_stats.get("nodes")} '
        f'nodes), so every call is dense, as in vega_tpu; chi2_batch({BATCH}) '
        f'{BATCH / float(np.median(times)):.1f} evals/s (s per call '
        f'{", ".join(f"{t:.4f}" for t in times)}); kernel launches '
        f'{launches["lyacolore_route"]}')
    del route_vega

    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(main_ini, device=device)
    models = list(dense_vega.models.values())
    mock_dense_regime(device, 'lyacolore', dense_vega, goldens, launches,
                      checks, hooks={
                          'power-spectrum grids (smoothing included)': [
                              (m.Pk_core, 'compute_peak_smooth')
                              for m in models],
                          'combine': [(pktoxi_mod,
                                       'spline_legendre_combine')]})

    # --- the dense fit: its gradient and Hessian run F_d, P_d and Ft_d;
    # counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        timed_fit(device, dense_vega, 'lyacolore dense')
    launches['lyacolore_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'lyacolore_fit', layouts)
    check_fit('lyacolore dense', 'mock', dense_vega, names,
              goldens['fit_dense'])
    by_primitive = {primitive: sum(
        n for key, n in launches['lyacolore_fit'].items()
        if key[0] == primitive and (primitive != 'F' or key[1] >= 1))
        for primitive in ('F', 'P', 'Ft')}
    log(f'lyacolore fit kernel launches: {launches["lyacolore_fit"]}; F_d '
        f'(d >= 1), P_d, Ft_d: {by_primitive}')
    if not all(by_primitive.values()):
        fail('the lyacolore dense fit launched no F_d (d >= 1), P_d or Ft_d')
    log(f'lyacolore phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# (name, primitive, orders, dtype, the TPU code it replaces: file:line,
# and which part of it); the f32 kernels (the Pallas kernels' own dtype)
# are rows of their own
FORWARD = ('vega_tpu/ops/pallas_spline.py:186',
           'spline_legendre_combine_batched (and :123)')
BACKWARD = ('vega_tpu/ops/pallas_spline.py:233',
            'the backward of make_vmappable_combine (custom_vjp :278-290)')
KERNELS = tuple(
    (name + (' (f32)' if dtype == 'f32' else ''), primitive, orders, dtype,
     replaces)
    for dtype in ('f64', 'f32')
    for name, primitive, orders, replaces in (
        ('spline_legendre_combine F_0', 'F', (0,), FORWARD),
        ('spline_legendre_combine F_d, d = 1..3', 'F', (1, 2, 3), BACKWARD),
        ('spline_legendre_combine P_d (no-sum mode)', 'P', (0, 1, 2, 3),
         BACKWARD),
        ('spline_legendre_combine_transpose Ft_d', 'Ft', (0, 1, 2, 3),
         BACKWARD)))


def kernel_records(launches, replays, checks, edge_checks):
    """The kernels' JSON record: per kernel its launches by path (and
    how many of them came from replays of a CUDA graph) and by order, its
    worst error against its plain version (recorded and edge
    layouts), ms / plain_ms / bound_ms at its largest checked layout
    (B x M) and every checked layout. No single PyTorch call computes
    the combine or its transpose: library_ms is null."""
    out = []
    for name, primitive, orders, dtype, (replaces, part) in KERNELS:
        def mine(key):
            """key: (primitive, d) of an f64 launch, (primitive, d, 'f32')
            of an f32 one."""
            return (key[0] == primitive and key[1] in orders
                    and (key[2] if len(key) > 2 else 'f64') == dtype)
        by_path = {path: sum(n for key, n in counts.items() if mine(key))
                   for path, counts in launches.items()}
        replayed_by_path = {
            path: sum(n for key, n in counts.items() if mine(key))
            for path, counts in replays.items()}
        by_order = {}
        for counts in launches.values():
            for key, n in counts.items():
                if mine(key):
                    by_order[key[1]] = by_order.get(key[1], 0) + n
        records = [r for r in checks
                   if mine((r['primitive'], r['order'], r['dtype']))]
        edges = [r for r in edge_checks
                 if mine((r['primitive'], r['order'], r['dtype']))]
        if not sum(by_path.values()) or not records:
            fail(f'{name}: no launch in any path')
        largest = max(records, key=lambda r: r['B'] * r['M'])
        out.append({
            'name': name, 'route': 'cuda',
            'source': 'vega_tpu_torch/csrc/spline_legendre_combine.cu',
            'replaces': replaces, 'replaces_part': part, 'dtype': dtype,
            'launches': sum(by_path.values()),
            'launches_by_path': by_path,
            'replayed_by_path': replayed_by_path,
            'launches_by_order': {str(k): v
                                  for k, v in sorted(by_order.items())},
            'max_abs_err': max(r['max_abs_err'] for r in records + edges),
            'max_err_of_ref': max(r['max_abs_err'] / r['max_abs_ref']
                                  for r in records + edges
                                  if r['max_abs_ref']),
            'ms': largest['ms'], 'plain_ms': largest['plain_ms'],
            'bound_ms': largest['bound_ms'], 'bound_by': largest['bound_by'],
            'library_ms': None,
            'edge_layouts_checked': len(edges),
            'layouts': records})
    return out


def main():
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs '
             'a GPU')
    import vega_tpu_torch  # noqa: F401  (fails outside a checkout)
    from vega_tpu_torch.ops.spline_combine import KnotGrid
    device = torch.device('cuda', torch.cuda.current_device())
    card = card_line()
    log(f'card: {card}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, python {sys.version.split()[0]}')

    t_start = time.perf_counter()
    marks = []

    def mark(phase):
        """Log the seconds since the last mark, under the phase that
        just ended."""
        marks.append((phase, time.perf_counter()))
        last = marks[-2][1] if len(marks) > 1 else t_start
        log(f'phase {phase}: {marks[-1][1] - last:.1f} s')

    build_kernels()
    mark('build')
    with tempfile.TemporaryDirectory() as work:
        # the grid payload's disk cache: off for the phases before table6
        # (each sweeps its payload, as before), and never outside `work`
        os.environ['VEGA_TPU_GRID_CACHE'] = '0'
        os.environ['VEGA_TPU_GRID_CACHE_DIR'] = str(Path(work) / 'grid_cache')
        from vega_tpu_torch.testing import make_synthetic_dataset
        t0 = time.perf_counter()
        main_ini = make_synthetic_dataset(work, cross=True, size='full',
                                          device=device)
        log(f'setup: synthetic full configuration in '
            f'{time.perf_counter() - t0:.2f} s')
        dense_launches, dense_checks, knot_grid = run_dense_path(
            device, main_ini)
        n_ell = dense_checks[0]['layout'][1]
        edge_checks = check_edge_layouts(device, knot_grid, n_ell)
        edge_checks += check_edge_layouts(
            device, legacy_knot_grid(device, main_ini), n_ell,
            'old_fftlog')
        mark('dense')
        grid_launches, grid_checks = run_grid_path(device, main_ini, card)
        mark('grid')
        fit_ini, fit_launches, fit_checks = run_fit_path(device, work)
        mark('fit')
        f32_launches, f32_checks = run_f32_path(device, fit_ini, card)
        edge_checks += check_edge_layouts(
            device, KnotGrid.build(knot_grid.values, device, torch.float32),
            n_ell, 'mcfit')
        mark('f32')
        scan_launches, scan_checks = run_scan_path(device, fit_ini)
        mark('scan')
        mc_launches, mc_checks = run_mc_path(device, work)
        mark('mc')
        sampler_launches, sampler_replays, sampler_checks = \
            run_sampler_paths(device, work, fit_ini)
        mark('samplers')
        dr16_launches, dr16_checks = run_dr16_path(device, work, card)
        mark('dr16')
        uv_launches, uv_checks, uv_edges = run_uv_path(device, work, card)
        edge_checks += uv_edges
        mark('uv')
        desi_launches, desi_checks = run_desi_path(device, work, card)
        mark('desi')
        marg_launches, marg_checks = run_marg_path(device, work, card)
        mark('marg')
        table6_launches, table6_checks = run_table6_path(device, work, card,
                                                         fit_ini)
        mark('table6')
        dr16pub_launches, dr16pub_checks = run_dr16pub_path(device, work,
                                                            card)
        mark('dr16pub')
        desi_mock_launches, desi_mock_checks = run_desi_mock_path(
            device, work, card)
        mark('desi_mock')
        lyacolore_launches, lyacolore_checks = run_lyacolore_path(
            device, work, card)
        mark('lyacolore')
        run_vega_launches, run_vega_checks = run_run_vega_path(
            device, work, card)
        mark('run_vega')
    log(f'all phases: {time.perf_counter() - t_start:.1f} s')

    checks = (dense_checks + grid_checks + fit_checks + f32_checks
              + scan_checks
              + mc_checks + sampler_checks + dr16_checks + uv_checks
              + desi_checks + marg_checks
              + table6_checks + dr16pub_checks + desi_mock_checks
              + lyacolore_checks + run_vega_checks)
    kernels = kernel_records(
        {'dense': dense_launches, 'grid': grid_launches, **fit_launches,
         **f32_launches,
         'scan': scan_launches, **mc_launches, **sampler_launches,
         **dr16_launches, **uv_launches, **desi_launches,
         **marg_launches, **table6_launches,
         **dr16pub_launches, **desi_mock_launches, **lyacolore_launches,
         **run_vega_launches},
        sampler_replays, checks, edge_checks)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
