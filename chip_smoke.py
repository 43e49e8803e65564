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
7b. the f32 mode in the scans, mock fits and samplers (phase
   f32_campaigns), after the sampler phase (NS, SMC and HMC through
   scripts/run_vega_sampler.py), on the f32 phase's interfaces: its grid
   payload serves every f32 run on the grid (`serving_payload`), and
   each run is held to the f64 run of the same configuration in this
   run (F64_CAMPAIGNS) within the f32 ladder, or under vega_tpu's gate
   for its f32 samplers (tests/test_bao_posterior_demo.py:121-124:
   |d mean| < sigma_64 + 1e-3, 0.6 < sigma_32 / sigma_64 < 1.67):
   - the 40 x 40 scan in one chunk: fval at every point against the f64
     scan, 16 points against the JAX f64 scan goldens; wall time,
     Newton iterations and valid rows beside f64's;
   - 32 dense mocks and 256 through the nuisance collapse, each in one
     chunk, the first 4 the numpy mocks of
     tests/data/torch_port_f32_campaign_goldens.json held to vega_tpu's
     f32 fits of them (values 1e-2 of its errors, chi^2 the ladder,
     valid equal); it fails unless the dense fits launched the f32 Ft_d
     and an f32 kernel of order d >= 1 at B > 1;
   - NS with its device loop (the f64 run's settings), replayed as one
     CUDA graph per iteration and held to the eager evolution (logl
     1e-6); logZ within 3 max(errors, 0.1) of the f64 run's; its host
     loop for a few iterations through `cli sample`; SMC; HMC on the
     payload (a warm-up of 300 trajectories) and in the dense regime
     (f32 F_d, P_d and Ft_d at B = chains inside the captured
     trajectory), each trajectory replayed and held to the eager one (u
     1e-5); `cli mc` and run_vega_mc_fits on its MOCKS (the Bestfit
     tables in float32 and equal); the HMC hook in f32; a small f32 NS
     evolution of the dense log-likelihood as a CUDA graph, its F_0
     counted per replay.

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
   - derivatives in each regime against the JAX goldens (1e-6 / 1e-8)
     and the JAX fit held as the port's minimum in each
     (`check_golden_minimum`: the Newton step 1e-2 / 1e-3 of the JAX
     errors, the errors 1e-3 / 1e-5, chi^2 2e-4 / 1e-8);
   it fails unless the metal stack launched F_0 on the dense and the
   grid path and Ft_d in the derivatives.
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
   - value and gradient at 2 points on both (1e-6 / 1e-8) and the JAX
     dense fit held as the port's minimum on the dense path
     (`check_golden_minimum`: the Newton step 1e-3 of the JAX errors,
     the errors 1e-5, chi^2 1e-8 of the JAX fval);
   - one dense chi^2 of the variants with a combine layout of their own
     (single_multipole = 0, fht_extrap on the auto without metals)
     against its golden (1e-8); HeII and the split bias evolution with
     OMEGAM are held on the CPU (tests/test_torch_model_terms.py);
   - every launch layout held as below, and the edge layouts on the
     legacy knot grid with two tables and on fht_extrap's grid;
   it fails unless the relativistic and asymmetry terms launched F_0 of
   two tables, the dense derivatives Ft_d of two tables, and single_multipole
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
   - derivatives at two points (1e-8); the JAX dense fit held as the
     port's minimum (`check_golden_minimum`: the Newton step from the
     JAX best fit 1e-2 of the JAX errors, the errors from the Hessian
     there 1e-3, chi^2 against the JAX fval 1e-4) in place of a 17-name
     fit from the start; one seeded global mock through
     initialize_monte_carlo around the JAX best fit (1e-8 of the JAX
     mock) and the JAX fit on it held the same way;
   it fails unless the metal stack launched F_0 on the dense and the
   grid path and Ft_d in the derivatives.
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
9c. the likelihood options (phase options), against
   tests/data/torch_port_options_goldens.json (vega_tpu on the same
   seeded files, tests/tools/make_torch_port_options_goldens.py):
   - configuration synthetic-desi-dr3-full: phase desi's files, the auto
     and the cross copied with BLINDING = desi_dr3 and a seeded DA_BLIND
     column (testing.with_blinding; the cross's line of sight reversed
     for BuildConfig's lyaxqso), the configs of DESI DR1's baseline
     written by the port's BuildConfig (testing.write_desi_example_configs:
     examples/DESI_data_setup/make_configs.py's options, 17 names with
     bias_QSO and no beta_QSO, priors), equal as text to vega_tpu's apart
     from the date and git-hash lines; every data vector DA_BLIND; dense
     chi2_batch at the goldens' 8 points (1e-8 relative; the shift from
     the unblinded chi^2 reported beside the JAX one) and at 8192 rows
     (finite; evals/s), and minimize() from the JAX best fit moved by 2
     JAX errors per name (`shifted_start`) against it (values 1e-3 of
     the JAX errors, errors 1e-3 relative, fval 1e-4;
     the minimum sits on L0_hcd's limit); it fails unless
     the metal stacks launched F_0 and the fit a kernel of order d >= 1
     and Ft_d;
   - use_full_pk_for_mc on phase mc's files with an empty [sample]: the
     fiducial of get_fiducial_for_monte_carlo (Model.compute_direct,
     through F_0) within 1e-10 of max|ref| of the JAX fiducial, 32 mocks
     around it fitted in one chunk over (ap, at, bias_LYA, beta_LYA), and
     the goldens' 4 numpy mocks against the JAX fits (as phase mc);
     profiling.time_likelihood on that interface (first call and steady
     rate) and one profiling.trace;
   - model_pk on the same files: compute_model's (4, 814) multipoles of
     both correlations within 1e-10 of max|ref| of vega_tpu's;
   - has_datafile = False in both correlations: the interface holds what
     vega_tpu's holds (no data, models, plots or modes) and each
     evaluation raises vega_tpu's exception.
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
   - that route at the JAX dense best fit: its chi^2, and the Newton
     step to its minimum in JAX errors (value, gradient and Hessian
     there; reported); the dense fit of this configuration is the
     run_vega phase's (`cli fit`, held against the same JAX dense fit);
   it fails unless the metal stacks launched F_0 on the dense path and
   in the sweep, each launch layout (the legacy knot grid's among them)
   held against its plain version. The legacy knot grid also joins the
   edge layouts.
11b. the f32 throughput mode on the eBOSS DR16 and DESI configurations
   (phase f32_models): synthetic-dr16-full, synthetic-desi-full and
   synthetic-dr16-published-full, on the files their f64 phases wrote,
   each with an interface built under VEGA_TPU_X64=0 (dense) or with
   dtype=torch.float32 (grid), against vega_tpu's f32 dense chi^2 of
   tests/data/torch_port_f32_models_goldens.json and its f64 goldens
   (tests/data/torch_port_{dr16,desi,dr16pub}_goldens.json) within the
   f32 ladder |d chi2| <= max(0.3, 3e-4 |chi2|):
   - dense chi2_batch(8192) with only f32 kernels launched and F_0 from
     the metal stacks, its first call and steady evals/s beside the f64
     phase's of the same run; chi^2 at the goldens' 8 points against
     vega_tpu's f64 (enforced) and f32 (enforced where vega_tpu's own
     f32 is within the ladder of its f64, else its gap is printed);
   - the grid route, cold, f32 kernels only: dr16 32 x 32 nodes, desi
     its 14 names under per-correlation covariances (each against
     vega_tpu's f64 grid goldens), dr16pub vega_tpu's route (the crosses
     from the 4-dimension payload, the autos dense: vega_tpu has no
     route goldens; held to the f64 route of phase dr16pub in the same
     run, f32 adding at most a tenth of that route's own distance from
     the JAX dense chi^2, the ladder reported: `check_f32_route`);
   - vega_tpu's f64 dense fit held as the f32 interface's minimum
     (`check_golden_minimum`: the f32 Newton step from it and the f32
     errors within 1e-2 of the JAX errors, chi^2 the ladder); it fails
     unless its derivatives launched the f32 Ft_d, an f32 kernel of
     order d >= 1 and F_0 from the metal stacks;
   every f32 launch layout is held against its f32 plain version (1e-5
   of max|ref|), and the six edge layouts run in f32 on the legacy knot
   grid too.
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
     chi^2 (2e-4 + 1e-9 |chi2|), evals/s at 8192 / 32768, and the JAX
     grid fit held as the port's minimum on the payload
     (`check_golden_minimum`: the Newton step 1e-2 / the errors 1e-3 of
     the JAX errors, chi^2 2e-4);
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
13b. The f32 mode on every model term (phase f32_terms), under
   VEGA_TPU_X64=0 (dense) or dtype=torch.float32, on the files phases
   desi_mock, lyacolore, uv, desi and table6 wrote (written here when
   they did not run), against vega_tpu's f32 dense chi^2 of
   tests/data/torch_port_f32_terms_goldens.json and the f64 goldens of
   those phases within the f32 ladder:
   - desi_mock (full-shape smoothing beside the new-metals stacks),
     lyacolore (per-row smoothing on old_fftlog's legacy grid) and uv
     (UV fluctuations and shotnoise, the relativistic and asymmetry
     pair, Croom): dense chi2_batch(8192) with only f32 kernels launched
     (F_0 from the metal stacks, the transform, or the pair's two
     tables), chi^2 at the goldens' 8 points (`f32_models_hold`), one
     timed round beside the f64 phase's evals/s and the device shares;
     the grid (desi_mock's 12 names) or vega_tpu's route (uv: the auto
     from the payload; lyacolore: every call dense), cold, against
     vega_tpu's f64 grid, route or dense chi^2; vega_tpu's f64 fit held
     as the f32 minimum (`check_golden_minimum`, regime 'f32'; uv's
     launches F_d, P_d and Ft_d of two tables);
   - uv's single_multipole (one table, a weight of 1) and fht_extrap
     variants and desi's rescale-coords-systematics variant, dense at
     their goldens' rows;
   - table6's 4-dimension payload swept in f32, cold, its route chi^2
     held to phase table6's f64 route (`check_f32_route`);
   - the six edge layouts in f32 on the legacy knot grid of the
     relativistic pair (L = 2) and on fht_extrap's knot grid.
13c. The f32 mode's likelihood options (phase f32_options), each
   interface built with dtype=torch.float32 on files phases marg, mc,
   options and dr16pub wrote (it fails if they did not), against
   vega_tpu's f32 numbers in
   tests/data/torch_port_f32_options_goldens.json ('full') and the f64
   goldens of phases marg, options and run_vega, within the
   f32 ladder:
   - synthetic-desi-marg-full (phase marg's files), the templates in the
     covariance: dense chi2_batch(8192) with only f32 kernels launched
     (F_0 from the metal stacks), the chi^2 at the goldens' 8 points,
     one timed round beside phase marg's f64 evals/s and the device
     shares; compute_marg_coeff at the JAX best fit (1e-4 of the
     largest coefficient); vega_tpu's grid route, cold, against
     vega_tpu's f64 grid chi^2;
   - the same with marginalize-in-fit (no collapse): the chi^2 at the 8
     points, value and gradient at the first derivative point against
     vega_tpu's f32 and f64, vega_tpu's f64 best fit held as the f32
     minimum (`check_golden_minimum`, regime 'f32'), the value there,
     and the coefficients the chi^2 fitted (float32) and
     compute_marg_coeff's (float64) against vega_tpu's;
   - save-components on phase dr16pub's files (make_dr16_published_
     dataset(..., components=True, files_from=...)): compute_model at
     the run_vega goldens' point, dense, the metals unrolled (F_0 at B =
     1 per pair), every saved component in float32 against vega_tpu's f32
     and f64 (1e-5 of max|f64| at the goldens' 64 indices), and the
     results file written through Output: every PK_ / Xi_ column float32
     and equal to the in-memory component;
   - model_pk's multipoles and use_full_pk_for_mc's fiducial on phase
     mc's files (phase options' inis) against vega_tpu's f32 and f64
     (1e-5 of max|f64|); correlations without a data file raising
     vega_tpu's f32 exception types.
13b. Several devices (phase devices), on the synthetic full
   configuration (vega_tpu_torch.parallel): make_device_mesh() spans the
   cards and make_device_mesh(2) cuts to them as vega_tpu cuts its
   devices; over a mesh of cuda:0 listed twice, BatchedLikelihood.chi2
   dense and on the grid payload at 8192 and 8191 rows against the
   unsharded chi2_batch (1e-12 of |chi^2|), the three timed in turns;
   batched_chi2_scan at the scan goldens' 16 points over the 2-entry mesh
   against the 1-entry mesh (1e-8 in fval) and the JAX goldens (as phase
   scan holds them); MonteCarloEngine.fit_mocks of 32 dense mocks over
   the 2-entry mesh against the 1-entry mesh and of the goldens' numpy
   mocks against the JAX fits (phase mc's gates); ShardedGlobalChi2 on
   phase desi's joint covariance against the one-device f64 quadratic
   form (1e-12); two processes (gloo, both on cuda:0) each holding
   every gathered chi^2 of 8192 rows over global_mesh() on the grid
   payload each swept, equal to the unsharded values (1e-12); this
   process's cached device memory is released first (empty_cache), so
   that the processes it starts find the card's memory; run_vega_mc
   --n-devices 2 against
   --n-devices 1 (one card: a mesh of one device; Bestfit 1e-10).
13c. The examples (phase examples, started within phase devices once
   its timed calls are done): the ten counterparts of the examples and
   tutorials (EXAMPLES), each in its own process on the card at its own
   settings, EXAMPLE_WORKERS at a time: exit 0 and its check printed.
14. A fit from the command line (phase run_vega), configuration
   synthetic-dr16-published-full with the components written
   (make_dr16_published_dataset(..., components=True): [output] write_pk
   and write_cf, fast_metals and fast_metal_bias off, which both packages
   require) on phase dr16pub's template, data and metal files
   (files_from), against tests/data/torch_port_run_vega_goldens.json:
   - `vega_tpu_torch.cli fit main.ini --device cuda` under
     VEGA_TPU_FACTORED=0 (run_vega: the interface, the fit, the results
     file, and the wedge and shell plots where matplotlib is installed,
     decided before the call; vega_tpu's route for the 18 names would
     sweep the payload and find nothing factored once the metals run
     unrolled, so every name is dense either way), timed, sampling six
     of the 18 names (ap, at, bias_eta_LYA, beta_LYA, bias_hcd,
     beta_hcd; the others at the configuration's values), its fit started
     at the JAX dense best fit moved by 2 JAX errors per name
     (`shifted_start`); the best fit against the JAX dense fit of the
     same six names (tests/data/torch_port_run_vega_fit_goldens.json;
     1e-2 / 1e-3 of the JAX errors);
   - the results file read back: MODEL_*, BESTFIT, PK_* and Xi_* of the
     four correlations, the MODEL_ models and BESTFIT's names, values,
     errors and covariance equal to the in-memory fit and every
     component column to the in-memory component, bit for bit;
     bao_amp x peak + smooth against the best-fit model (1e-12);
   - the components at the goldens' point, the metal pairs' own
     (model.metals) among them, against vega_tpu's (1e-10 of max|ref|
     at 64 indices and in norm);
   - compute_sensitivity_exact over the 18 names at the goldens' nominal
     (1e-9) and compute_sensitivity over ap, 2 rebuilds (1e-8),
     partials and Fisher sums;
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
import types
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
# run_vega's `cli fit` samples these six of the published fit's 18 names
# (the others at the configuration's values): its cost follows the names,
# 76-130 s for the 18
RUN_VEGA_FIT_GOLDENS = (ROOT / 'tests' / 'data'
                        / 'torch_port_run_vega_fit_goldens.json')
UV_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_uv_goldens.json'
MARG_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_marg_goldens.json'
OPTIONS_GOLDENS = (ROOT / 'tests' / 'data'
                   / 'torch_port_options_goldens.json')
# the marg phase's template coefficients against the JAX package's, of
# their largest entry (PERF.md section 2)
MARG_COEFF_RTOL = 1e-8
F32_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_f32_goldens.json'
F32_MODELS_GOLDENS = (ROOT / 'tests' / 'data'
                      / 'torch_port_f32_models_goldens.json')
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
# dr16pub's f32 route against its f64 route: at most this share of the
# f64 route's own distance from the dense chi^2 (check_f32_route)
F32_ROUTE_SHARE = 0.1
# the run_vega phase against the JAX goldens, each of the largest entry of
# the reference vector: the saved components at the goldens' point, the
# exact partials (and the Fisher sums, of the sum of their bins'
# absolute values), the central differences; bao_amp x peak + smooth
# against the returned model
COMPONENT_RTOL = 1e-10
SENSITIVITY_EXACT_RTOL = 1e-9
SENSITIVITY_FD_RTOL = 1e-8
# the run_vega phase's central differences over the first of the
# goldens' four names (ap): 2 model rebuilds (4 until the f32_campaigns
# phase was added, 8 until the options phase)
FD_SENSITIVITY_NAMES = 1
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
                   'published': 1e-2, 'mock': 1e-2, 'blinded': 1e-3,
                   'f32': 1e-2}
FIT_ERROR_RTOL = {'grid': 1e-3, 'dense': 1e-5, 'joint': 1e-3,
                  'published': 1e-3, 'mock': 1e-3, 'blinded': 1e-3,
                  'f32': 1e-2}
FIT_FVAL_ABS = {'grid': GRID_ABS_TOL, 'dense': 1e-8, 'joint': 1e-4,
                'published': 1e-4, 'mock': 1e-4, 'blinded': 1e-4}
# run_vega's `cli fit` and options desi_dr3's fit start this many JAX
# errors per name away from the JAX best fit (`shifted_start`)
FIT_START_SIGMAS = 2.0
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
# the options phase: compute_direct's fiducial and the model_pk
# multipoles against vega_tpu's, max|diff| <= OPTION_MODEL_RTOL
# max|ref|; mocks fitted around the fiducial in one chunk; calls of
# profiling.time_likelihood
OPTION_MODEL_RTOL = 1e-10
OPTIONS_MOCKS = 32
PROFILE_EVALS = 20
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
# 300 + 100 trajectories, in f64 and in f32: after a warm-up of 100 the
# split-R-hat < 1.1 gate is a draw's luck in either dtype (on the CPU at
# full size, seeds 1 and 2: f64 2.28 and 2.20, f32 2.60 and 1.42; after
# 300, seeds 1-3: at most 1.005 in both); 3,200 draws hold the moments
# to their bounds
HMC_GRID_SETTINGS = {'num_chains': 32, 'num_warmup': 300,
                     'num_samples': 100, 'num_leapfrog': 16, 'seed': 0}
HMC_DENSE_SETTINGS = {'num_chains': 32, 'num_warmup': 20, 'num_samples': 20,
                      'num_leapfrog': 8, 'seed': 0}
# the dense log-likelihood's evolution as a graph: chains, repeats,
# shrink steps
NS_DENSE_SHAPE = (8, 2, 3)
# the f32_campaigns phase against the f64 runs of the scan, mc and
# sampler phases (F64_CAMPAIGNS, filled by them) and vega_tpu's f32 mock
# fits. In f32: a replayed evolution's logl against the eager one, a
# replayed trajectory's u against the eager one (absolute; u is O(1)):
# f32 round-off, where f64 holds 1e-12 and 1e-12
F32_CAMPAIGN_GOLDENS = (ROOT / 'tests' / 'data'
                        / 'torch_port_f32_campaign_goldens.json')
# the f32 Monte-Carlo scripts' mocks: one chunk at the default chunk of 8
# (each chunk runs the f32 Newton's 200 iterations: 64 mocks took 49 s)
F32_MC_SCRIPT_MOCKS = DEFAULT_FIT_CHUNK
F32_EVOLVE_LOGL_RTOL = 1e-6
# an f32 chain's -2 ln L column against -2 log_lik_batch at the point
# the sampler evaluated: the sampler's traceable log-likelihood and
# log_lik_batch sum the chi^2 over the n masked bins in other orders, so
# the bound is the f32 round-off of such a sum, sqrt(n) unit round-offs
# of max(|chi^2|, |2 ln L0|), and never more than the ladder
F32_UNIT_ROUNDOFF = 2.0 ** -24
F32_TRAJECTORY_ATOL = 1e-5
F64_CAMPAIGNS = {}


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


SECOND_DERIVATIVES = {}


def random_case(rng, device, grid, layout):
    """Random inputs of one recorded launch layout: tables with their
    not-a-knot second derivatives, queries with about 5% outside the
    knot range, Legendre weights (or the transpose's g) in [-1, 1];
    shared rows with row stride 0. The second derivatives are an f64
    product on `device` with the grid's matrix, built once per grid (on
    the host, the product of a B = 15,360 layout took seconds), then
    cast to the grid's dtype."""
    from vega_tpu_torch.ops.spline import notaknot_second_derivative_matrix
    n_b, n_ell, n_knots, group, n_x, n_q, x_shared, leg_shared = layout[:8]
    logr = grid.values
    span = logr[-1] - logr[0]

    def tensor(a):
        return torch.as_tensor(a, dtype=grid.dtype, device=device)

    key = (len(logr), float(logr[0]), float(logr[-1]), str(device))
    if key not in SECOND_DERIVATIVES:
        SECOND_DERIVATIVES[key] = torch.as_tensor(
            notaknot_second_derivative_matrix(logr).T, dtype=torch.float64,
            device=device)
    y_np = rng.normal(size=(n_b, n_ell, n_knots))
    y = tensor(y_np)
    m = (torch.as_tensor(y_np, dtype=torch.float64, device=device)
         @ SECOND_DERIVATIVES[key]).to(grid.dtype)
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
    # the device's activity alone: the kernels are all it reads (with the
    # host's ops too, events() took 1.5-2.3x as long)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def shifted_start(vega, names, want):
    """The JAX best fit (`want`: its values and errors) moved by
    FIT_START_SIGMAS JAX errors per name, up for the first name, down for
    the next and so on, and the other way where a step would leave the
    name's limits: a start near the minimum from which the fit has to
    find it again."""
    limits = vega.sample_params['limits']
    start = {}
    for i, (name, value, error) in enumerate(zip(names, want['values'],
                                                 want['errors'])):
        lo, hi = limits[name]
        lo = -np.inf if lo is None else lo
        hi = np.inf if hi is None else hi
        step = FIT_START_SIGMAS * error * (1 if i % 2 == 0 else -1)
        if not lo <= value + step <= hi:
            step = -step
        start[name] = float(np.clip(value + step, lo, hi))
    return start


def check_golden_minimum(label, device, vega, names, want, regime):
    """The JAX fit's best point held as the port's minimum, in place of
    a fit from the start: at the JAX best-fit values, the Newton step
    H^-1 g to the port's minimum in JAX errors, the errors sqrt(diag(2
    H^-1)) the minimizer takes at a minimum (minimizer._compute_errors)
    against the JAX errors, and the chi^2 against the JAX fval, under
    check_fit's bounds for `regime`; regime 'f32' (an f32 interface
    against an f64 JAX fit) takes F32_FIT_SIGMA for the step and the
    errors and the f32 ladder for the chi^2. A minimum on a limit of
    [sample] has no zero gradient: the check refuses it."""
    point = dict(zip(names, want['values']))
    on_limit = [n for n in names if any(
        lim is not None and np.isclose(point[n], lim, rtol=0, atol=1e-9)
        for lim in vega.sample_params['limits'][n])]
    if on_limit:
        fail(f'{label}: the JAX best fit sits on the limits of {on_limit}; '
             'hold it with a fit')
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    value, grad = vega.chi2_value_and_gradient(point)
    hess = vega.chi2_hessian(point, list(names))
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    g = np.array([grad[n] for n in names])
    h = np.array([[hess[a][b] for b in names] for a in names])
    errors = np.sqrt(np.diag(2.0 * np.linalg.inv(h)))
    d_sigma = float(np.max(np.abs(np.linalg.solve(h, g))
                           / np.asarray(want['errors'])))
    d_err = float(np.max(np.abs(errors / np.asarray(want['errors']) - 1)))
    d_fval = abs(value - want['fval'])
    log(f'{label} at the JAX best fit ({seconds:.3f} s: value, gradient, '
        f'Hessian): Newton step to the port\'s minimum {d_sigma:.3e} JAX '
        f'errors, errors max relative diff {d_err:.3e}, chi2 {value!r} '
        f'(JAX fval {want["fval"]!r})')
    if not np.all(np.isfinite(errors)):
        fail(f'{label}: the Hessian at the JAX best fit is not positive '
             'definite')
    if not d_sigma <= FIT_VALUE_SIGMA[regime]:
        fail(f'{label}: the port\'s minimum is {d_sigma:.3e} errors from '
             f'the JAX best fit > {FIT_VALUE_SIGMA[regime]:g}')
    if not d_err <= FIT_ERROR_RTOL[regime]:
        fail(f'{label} errors differ by {d_err:.3e} relative > '
             f'{FIT_ERROR_RTOL[regime]:g}')
    if regime == 'f32':
        f32_ladder(f'{label} chi2 at the JAX best fit vs its fval', [value],
                   [want['fval']])
    elif not d_fval <= FIT_FVAL_ABS[regime]:
        fail(f'{label} chi2 at the JAX best fit differs from its fval by '
             f'{d_fval:.3e} > {FIT_FVAL_ABS[regime]:g}')


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
    of its paths, the kernel checks at their layouts, and its two f32
    interfaces {'dense', 'grid'} (the grid one holding its swept payload)
    for the f32_campaigns phase."""
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
    return launches, checks, {'dense': dense, 'grid': grid}


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
            seconds = stats['wall_s'] = time.perf_counter() - t0
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
    F64_CAMPAIGNS['scan'] = scan(axis, n_axis ** 2,
                                 f'{n_axis} x {n_axis} warm')
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
        seconds = stats['wall_s'] = time.perf_counter() - t0
    log(f'{label}: {n_mocks} mocks in chunks of {chunk}, {seconds:.3f} s '
        f'wall, {seconds / n_mocks:.4f} s per fit, Newton iterations per '
        f'chunk {stats["iterations"]}, host waiting in the stopping tests '
        f'{stats["sync_s"]:.3f} s, valid {float(np.mean(fits["valid"])):.4f}'
        f', peak device memory '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB')
    return {**fits, 'stats': stats}


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
                if chunk == count == n_mocks:
                    F64_CAMPAIGNS[f'mc_{kind}'] = fits['stats']
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
    column equal to -2 log_lik_batch at its points (not for HMC, whose
    column is twice the potential, log-Jacobian included): within
    SAMPLER_LOGL_RTOL relative in f64; in f32, at the point the sampler
    evaluated, within sqrt(n) f32 unit round-offs of max(|chi^2|, |2 ln
    L0|) over n masked bins and within the ladder (-2 ln L is chi^2 less
    twice the normalisation, 2 ln L0 ~ 1e5 here, so near chi^2 = 2 ln L0
    a bound relative to -2 ln L measures nothing). Returns the chain."""
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
    points = {n: chain[:, 2 + i] for i, n in enumerate(names)}
    want = -2.0 * vega.log_lik_batch(points).cpu().numpy()
    if vega.dtype == torch.float32:
        # the point the sampler evaluated: the host loops the written one,
        # lo + u (hi - lo) in f64 rounded to f32; the device evolution lo +
        # u span in f32 (DeviceEvolve), which may differ from it by an f32
        # ulp, and far from the minimum the chi^2 by many ulps with it.
        # Each row is held at the nearer of the two
        def tensor(values):
            return torch.tensor(values, dtype=vega.dtype, device=vega.device)

        lo32 = tensor(lo.tolist())
        span32 = tensor(hi.tolist()) - lo32
        u = tensor(((chain[:, 2:] - lo) / (hi - lo)).astype(np.float32))
        x32 = (lo32 + u * span32).cpu().numpy().astype(float)
        on_device = -2.0 * vega.log_lik_batch(
            {n: x32[:, i] for i, n in enumerate(names)}).cpu().numpy()
        chi2 = vega.chi2_batch(points).cpu().numpy()
        two_log_norm = 2 * vega._log_norm()
        scale = np.maximum(np.abs(chi2), abs(two_log_norm))
        ulp = np.spacing(scale.astype(np.float32)).astype(float)
        n_bins = sum(vega.data[n].data_size for n in vega.corr_items)
        bound = np.minimum(np.sqrt(n_bins) * F32_UNIT_ROUNDOFF * scale,
                           np.maximum(F32_CHI2_ABS,
                                      F32_CHI2_REL * np.abs(chi2)))
        written = np.abs(chain[:, 1] - want)
        d = np.minimum(written, np.abs(chain[:, 1] - on_device))
        worst = int(np.argmax(d / bound))
        log(f'{label}: chain {chain.shape[0]} x {chain.shape[1]}, finite, '
            f'inside the limits; -2 ln L column vs -2 log_lik_batch at the '
            f'point evaluated: max {np.max(d / ulp):.3g} f32 ulps of '
            f'max(|chi2|, |2 ln L0|), {d[worst] / bound[worst]:.3g} of the '
            f'bound ({d[worst]:.4g} at chi2 {chi2[worst]:.6g}, 2 ln L0 '
            f'{two_log_norm:.6g}, {n_bins} bins), rows equal '
            f'{int(np.sum(d == 0))}, {int(np.sum(d < written))} of them at '
            f'the device\'s f32 point; at the written point max '
            f'{np.max(written / ulp):.3g} ulps')
        if not d[worst] <= bound[worst]:
            fail(f'{label}: the chain\'s -2 ln L differs from log_lik_batch '
                 f'by {d[worst]:.4g} at chi2 {chi2[worst]:.6g}')
        return chain
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
                       replays, eager_runs, rtol=EVOLVE_LOGL_RTOL):
    """One evolution on the same inputs and random numbers, replayed from
    the CUDA graph and run eagerly: logl within `rtol` (EVOLVE_LOGL_RTOL
    in f64, F32_EVOLVE_LOGL_RTOL in f32), u and the counts equal (an
    accept test within round-off of l_min could part the two; the message
    says so if it happens). Returns the median seconds of a replay and of
    an eager run."""
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
        f'relative diff {d_logl:.3e} (bound {rtol:g}), u '
        f'{"equal" if same_u else "DIFFERENT"}, steps and moves '
        f'{outs[True][-2:].tolist()} vs {outs[False][-2:].tolist()}; s per '
        f'evolution replayed {seconds[True]:.4f} (median of {replays}), '
        f'eager {seconds[False]:.4f} (median of {eager_runs}), x'
        f'{seconds[False] / seconds[True]:.2f}')
    if not (d_logl <= rtol and same_u and same_counts):
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
    F64_CAMPAIGNS['ns'] = {'mean': mean, 'std': std, 'logz': result['logz'],
                           'logz_err': result['logz_err'],
                           'iterations': iterations, 'replay_s': replay_s}
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
    F64_CAMPAIGNS['ns_host_s'] = float(np.median(host_s))
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
    F64_CAMPAIGNS['smc'] = {'mean': mean, 'std': std, 'logz': result['logz'],
                            'stages': stages, 'seconds': seconds}
    check_moments('SMC', names, mean, std, fit_goldens['fit_grid'],
                  2 * NS_MEAN_SIGMA, 2 * NS_STD_RTOL)
    if not np.isfinite(result['logz']):
        fail('SMC logZ is not finite')


def hmc_trajectory_times(device, label, sampler, result, atol=1e-12):
    """One trajectory at the run's last positions, step size and metric,
    in the sampler's dtype: eager and as a CUDA graph, on the same
    momenta and uniforms (u within `atol`: 1e-12 in f64,
    F32_TRAJECTORY_ATOL in f32); a torch.profiler breakdown of the eager
    one. Returns (graph s, eager s)."""
    from vega_tpu_torch.samplers.hmc import GraphedStep, make_hmc_step

    chains, ndim = sampler.num_chains, sampler.num_params
    lo = np.array([sampler.limits[n][0] for n in sampler.names])
    hi = np.array([sampler.limits[n][1] for n in sampler.names])
    unit = (result['samples'][-chains:] - lo) / (hi - lo)

    def tensor(values):
        return torch.as_tensor(np.asarray(values, dtype=np.float64),
                               dtype=sampler.dtype, device=device)

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
                        dtype=sampler.dtype, device=device)
        log_unif = torch.log(torch.rand(chains, generator=generator,
                                        dtype=sampler.dtype, device=device))
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
            f'{capture_s:.3f} s; max |u replayed - u eager| {d_u:.3e} (bound '
            f'{atol:g})')
        if not d_u <= atol:
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


def run_hmc_hook(device, out, dtype=torch.float64):
    """HMC's standalone hook on the card in `dtype`: a plain torch chi^2
    (an uncorrelated Gaussian inside a box) with no device argument, its
    trajectory captured as a CUDA graph like the interface's. Mean within
    0.2 sigma of the truth, sigma within 15%, acceptance in (0.5, 1],
    split-R-hat < 1.1."""
    import configparser
    from vega_tpu_torch.samplers.hmc import HMC, GraphedStep

    label = 'HMC hook' + (' f32' if dtype == torch.float32 else '')
    mean = torch.tensor(HOOK_MEAN, dtype=dtype, device=device)
    sigma = torch.tensor(HOOK_SIGMA, dtype=dtype, device=device)

    def chi2(x):
        return torch.sum(((x - mean) / sigma) ** 2, dim=-1)

    path = Path(out) / label.replace(' ', '_')
    path.mkdir(parents=True, exist_ok=True)
    config = configparser.ConfigParser()
    config['HMC'] = {'path': str(path), 'name': 'hook',
                     **{k: str(v) for k, v in HOOK_SETTINGS.items()}}
    t0 = time.perf_counter()
    sampler = HMC(config['HMC'], HOOK_LIMITS, chi2, dtype=dtype)
    result = sampler.run()
    seconds = time.perf_counter() - t0
    if sampler.device.type != 'cuda' or not isinstance(
            sampler._step, GraphedStep) or sampler.dtype != dtype:
        fail(f'the {label} did not run its trajectory in {dtype} as a CUDA '
             'graph on the card')
    got_mean = result['samples'].mean(axis=0)
    got_sigma = result['samples'].std(axis=0)
    d_mean = np.abs(got_mean - np.array(HOOK_MEAN)) / np.array(HOOK_SIGMA)
    d_sigma = np.abs(got_sigma / np.array(HOOK_SIGMA) - 1)
    log(f'{label} (plain torch chi^2 on {sampler.device}): settings '
        f'{HOOK_SETTINGS}; {seconds:.3f} s, acceptance '
        f'{result["accept_rate"]:.3f}, split-R-hat '
        f'{result["r_hat"].tolist()}, |mean - truth| / sigma '
        f'{d_mean.tolist()} (bound 0.2), |sigma / truth - 1| '
        f'{d_sigma.tolist()} (bound 0.15)')
    if not (0.5 < result['accept_rate'] <= 1.0
            and np.max(result['r_hat']) < 1.1 and np.all(d_mean <= 0.2)
            and np.all(d_sigma <= 0.15)):
        fail(f'the {label}\'s run on the card missed its bounds')


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
    F64_CAMPAIGNS['hmc_grid'] = {
        'mean': mean, 'std': std, 'seconds': seconds,
        'trajectory_s': hmc_trajectory_times(device, 'HMC grid', sampler,
                                             result)[0]}
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
    launched_at_chains('the dense HMC run', layouts, chains, 'f64')
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
    F64_CAMPAIGNS['hmc_dense'] = {
        **dict(zip(('mean', 'std'), weighted_moments(
            result['samples'], np.ones(len(result['samples']))))),
        'seconds': seconds,
        'trajectory_s': hmc_trajectory_times(device, 'HMC dense', sampler,
                                             result)[0]}
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
# The f32 throughput mode in the scans, mock fits and samplers
# ----------------------------------------------------------------------
def f32_posterior_gate(label, names, mean, std, want, enforce=True):
    """vega_tpu's gate for its f32 samplers (tests/
    test_bao_posterior_demo.py:121-124): per name |mean - f64 mean| <
    f64 sigma + 1e-3 and 0.6 < sigma / f64 sigma < 1.67, against the f64
    run of the same configuration in this run (`want`: its mean and
    std)."""
    d_mean = np.abs(mean - want['mean']) - want['std']
    ratio = std / want['std']
    within = bool(np.all(d_mean < 1e-3) and np.all((0.6 < ratio)
                                                   & (ratio < 1.67)))
    log(f'{label}: posterior mean {mean.tolist()}, sigma {std.tolist()} '
        f'for {names}; f64 mean {want["mean"].tolist()}, sigma '
        f'{want["std"].tolist()}; |d mean| - f64 sigma {d_mean.tolist()} '
        f'(< 1e-3), sigma / f64 sigma {ratio.tolist()} (0.6 .. 1.67): '
        + ('within' if within else 'OUTSIDE')
        + ('' if enforce else ' (reported, not enforced)'))
    if enforce and not within:
        fail(f'{label}: the f32 posterior misses the f64 one')


@contextlib.contextmanager
def after_init(hook):
    """While open, every VegaInterface built (by a script or the cli
    included) calls hook(interface) once constructed."""
    from vega_tpu_torch import vega_interface
    original = vega_interface.VegaInterface.__init__

    def init(self, *args, **kwargs):
        original(self, *args, **kwargs)
        hook(self)

    vega_interface.VegaInterface.__init__ = init
    try:
        yield
    finally:
        vega_interface.VegaInterface.__init__ = original


def serving_payload(source):
    """A context in which every interface of `source`'s dtype built with
    the grid collapse (the scripts') serves `source`'s sampled names from
    the grid payload `source` swept (use_grid_payload): the payload of
    the same files and limits, swept once."""
    names = frozenset(source.sample_params['limits'])
    payload = source.get_collapsed(names)

    def serve(vega):
        if vega.dtype == source.dtype and vega._factored:
            vega.use_grid_payload(names, payload)

    return after_init(serve)


def launched_at_chains(label, layouts, chains, dtype):
    """Fail unless F_d (d >= 1), P_d and Ft_d launched at B = chains in
    `dtype` ('f64' or 'f32'): a gradient call's kernels at the chains'
    batch."""
    at_chains = [key for key in layouts
                 if key[2] == chains and layout_dtype(key[2:]) == dtype]
    for wanted, found in (
            ('F_d with d >= 1', any(k[0] == 'F' and k[1] >= 1
                                    for k in at_chains)),
            ('P_d', any(k[0] == 'P' for k in at_chains)),
            ('Ft_d', any(k[0] == 'Ft' for k in at_chains))):
        if not found:
            fail(f'{label} launched no {dtype} {wanted} at B = {chains}')


def f32_launches(label, counts):
    """Fail on any f64 launch of an f32 run."""
    f64 = {k: n for k, n in counts.items() if len(k) == 2 and n}
    if f64:
        fail(f'{label}: f64 kernel launches {f64}')


def run_f32_scan(device, grid, launches):
    """The f32 scan: the scan phase's 40 x 40 (ap, at) grid in one chunk
    on the f32 phase's payload, against the f64 scan of the run and the
    JAX f64 scan goldens."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import batched_chi2_scan

    goldens = json.loads(MC_GOLDENS.read_text())['scan']
    lo, hi, n_axis = goldens['axis']
    axis = np.linspace(lo, hi, n_axis)
    rows64, stats64 = F64_CAMPAIGNS['scan']
    stats = {}
    LAUNCHES.clear()
    with recorded_launches() as layouts, switch(
            'VEGA_TPU_FIT_CHUNK_PER_DEVICE', str(n_axis ** 2)):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        rows = batched_chi2_scan(grid, {'ap': axis, 'at': axis},
                                 stats=stats)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    launches['f32_scan'] = dict(LAUNCHES)
    f32_launches('f32 scan', launches['f32_scan'])
    log(f'f32 scan {n_axis} x {n_axis} on the f32 payload, one chunk: '
        f'{seconds:.3f} s wall (f64 warm {stats64["wall_s"]:.3f} s, f32 / '
        f'f64 {seconds / stats64["wall_s"]:.3f}), Newton iterations '
        f'{stats["iterations"]} (f64 {stats64["iterations"]}), host waiting '
        f'in the stopping tests {stats["sync_s"]:.3f} s, valid rows '
        f'{stats["valid_rows"]} of {len(rows)} (f64 '
        f'{stats64["valid_rows"]}); kernel launches {launches["f32_scan"]}')
    f32_ladder('f32 scan vs the f64 scan of this run (1,600 points)',
               [r['fval'] for r in rows], [r['fval'] for r in rows64])
    got, d_sigma = [], 0.0
    for want in goldens['rows']:
        i = int(np.argmin(np.abs(axis - want['ap'])))
        j = int(np.argmin(np.abs(axis - want['at'])))
        row = rows[i * n_axis + j]
        got.append(row['fval'])
        d_sigma = max(d_sigma, max(abs(row[n] - want[n]) / want['errors'][n]
                                   for n in goldens['free']))
    f32_ladder('f32 scan vs the JAX f64 scan goldens (16 points)', got,
               [w['fval'] for w in goldens['rows']])
    log(f'f32 scan vs the JAX f64 scan goldens: max |d value| / error '
        f'{d_sigma:.3e} (reported)')
    if not all(np.isfinite(r['fval']) for r in rows):
        fail('an f32 scan point is not finite')
    return check_launches(device, 'f32_scan', layouts)


def run_f32_mock_fits(device, grid, launches):
    """The f32 mock fits on the f32 phase's interface: MC_DENSE_MOCKS
    dense and MC_COLLAPSE_MOCKS through the nuisance collapse, each in
    one chunk, the first 4 of each the f32 goldens' numpy mocks and the
    rest drawn by generate_mocks."""
    import configparser

    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import MonteCarloEngine

    mc_goldens = json.loads(MC_GOLDENS.read_text())
    goldens = json.loads(F32_CAMPAIGN_GOLDENS.read_text())['full']
    limits = {n: [float(v) for v in e.split()[:2]]
              for n, e in mc_goldens['sample'].items()}
    if limits != {n: list(v) for n, v in
                  grid.sample_params['limits'].items()}:
        fail('the f32 interface samples otherwise than the MC goldens')
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read_string(mc_goldens['mc_control'])
    mc_params = {n: float(v) for n, v in config['mc parameters'].items()}
    fiducial = grid.compute_model(mc_params, run_init=False)
    engine = MonteCarloEngine(grid)
    checks = []
    for kind, n_mocks in (('dense', MC_DENSE_MOCKS),
                          ('collapse', MC_COLLAPSE_MOCKS)):
        want = goldens[kind]
        n_golden = len(want['chisq'])
        sample = {key: {n: grid.sample_params[key][n] for n in want['names']}
                  for key in ('limits', 'values', 'errors', 'fix')}
        golden = numpy_mocks(grid, fiducial, n_golden, want['seed'])
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            drawn = engine.generate_mocks(fiducial, n_mocks - n_golden,
                                          seed=MC_SEED)
            mocks = {name: torch.cat([torch.as_tensor(
                golden[name], dtype=grid.dtype, device=device), m])
                for name, m in drawn.items()}
            fits = timed_mock_fits(device, engine, mocks, sample, n_mocks,
                                   f'f32 mc {kind}')
        launches[f'f32_mc_{kind}'] = dict(LAUNCHES)
        f32_launches(f'f32 mc {kind}', launches[f'f32_mc_{kind}'])
        f64 = F64_CAMPAIGNS[f'mc_{kind}']
        log(f'f32 mc {kind}: {fits["stats"]["wall_s"]:.3f} s for {n_mocks} '
            f'mocks in one chunk (f64 {f64["wall_s"]:.3f} s, f32 / f64 '
            f'{fits["stats"]["wall_s"] / f64["wall_s"]:.3f}), iterations '
            f'{fits["stats"]["iterations"]} (f64 {f64["iterations"]}), '
            f'valid {fits["stats"]["valid_rows"]} of {n_mocks} (f64 '
            f'{f64["valid_rows"]}); kernel launches '
            f'{launches[f"f32_mc_{kind}"]}')
        d_sigma = float(np.max(np.abs(fits['values'][:n_golden]
                                      - np.asarray(want['values']))
                               / np.asarray(want['errors'])))
        valid = fits['valid'][:n_golden].tolist()
        log(f'f32 mc {kind} vs vega_tpu\'s f32 fits of the same {n_golden} '
            f'mocks: max |d value| / error {d_sigma:.3e} (gate '
            f'{F32_FIT_SIGMA:g}), valid {valid} (vega_tpu f32 '
            f'{want["valid"]})')
        f32_ladder(f'f32 mc {kind} chi2 vs vega_tpu\'s f32',
                   fits['chisq'][:n_golden], want['chisq'])
        if not (d_sigma <= F32_FIT_SIGMA and valid == want['valid']):
            fail(f'f32 mc {kind}: the golden mocks\' fits miss vega_tpu\'s')
        checks += check_launches(device, f'f32_mc_{kind}', layouts)
        if kind == 'dense':
            batched = [key for key in layouts if key[2] > 1
                       and layout_dtype(key[2:]) == 'f32']
            if not (any(key[0] == 'Ft' for key in batched)
                    and any(key[1] >= 1 for key in batched)):
                fail('the f32 dense mock fits launched no f32 Ft_d or no '
                     'f32 kernel of order d >= 1 at B > 1')
    return checks


def run_f32_samplers(device, fit_ini, grid, out, launches, replays):
    """The f32 samplers through scripts/run_vega_sampler.py under
    VEGA_TPU_X64=0 at the f64 sampler phase's settings, the grid ones on
    the f32 phase's payload (`serving_payload`): NS with its device loop,
    HMC on the payload and in the dense regime, SMC; and a small f32 NS
    evolution of the dense log-likelihood as a CUDA graph."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES, REPLAYED,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import BatchedLikelihood
    from vega_tpu_torch.samplers.hmc import HMC, GraphedStep
    from vega_tpu_torch.samplers.nested import DeviceEvolve, NestedSampler
    from vega_tpu_torch.samplers.smc import SMCSampler

    from vega_tpu_torch import cli

    goldens = json.loads(SAMPLER_GOLDENS.read_text())
    names = goldens['names']
    checks = []
    with serving_payload(grid), switch('VEGA_TPU_X64', '0'):
        # --- NS, device loop
        ini = sampler_ini(fit_ini, out / 'ns32', 'NestedJax',
                          goldens['settings'])
        evolve_s = []
        LAUNCHES.clear()
        REPLAYED.clear()
        with recorded_launches() as layouts, timed_method(
                NestedSampler, '_slice_evolve_device', device, evolve_s):
            vega, sampler, result, seconds = run_sampler_script(
                device, ini, 'f32 NS device loop', NestedSampler)
        launches['f32_ns'], replays['f32_ns'] = dict(LAUNCHES), dict(
            REPLAYED)
        f32_launches('f32 NS', launches['f32_ns'])
        evolve = sampler._evolve_fn
        if vega.dtype != torch.float32 or evolve is None \
                or evolve.graph is None or evolve.dtype != torch.float32:
            fail('the f32 NS device loop did not run in f32 as a CUDA graph')
        if launches['f32_ns']:
            fail('the f32 NS run launched a kernel: the f32 phase\'s '
                 'payload did not serve it')
        stats = read_stats(out / 'ns32')
        f64 = F64_CAMPAIGNS['ns']
        replay_s = float(np.median(evolve_s[1:]))
        mean, std = weighted_moments(result['samples'], result['weights'])
        log(f'f32 NS device loop: {stats["num_iterations"]} iterations (f64 '
            f'{f64["iterations"]}), logZ = {result["logz"]:.4f} +/- '
            f'{result["logz_err"]:.4f} (f64 {f64["logz"]:.4f} +/- '
            f'{f64["logz_err"]:.4f}), {replay_s:.4f} s per iteration '
            f'replayed (f64 {f64["replay_s"]:.4f}, f32 / f64 '
            f'{replay_s / f64["replay_s"]:.3f}), first with the capture '
            f'{evolve_s[0]:.3f} s, run {seconds:.3f} s; kernel launches '
            f'{launches["f32_ns"]}')
        check_chain('f32 NS device loop', vega, out / 'ns32', names,
                    vega.sample_params['limits'])
        f32_posterior_gate('f32 NS', names, mean, std, f64)
        bound = 3.0 * max(result['logz_err'], f64['logz_err'], 0.1)
        if not abs(result['logz'] - f64['logz']) <= bound:
            fail(f'f32 NS logZ {result["logz"]:.4f} is not within '
                 f'{bound:.3f} of the f64 run\'s {f64["logz"]:.4f}')
        live_logl = sampler._batch_log_lik(
            sampler.prior_transform(sampler.live_u))
        chol = np.linalg.cholesky(np.cov(sampler.live_u, rowvar=False)
                                  + 1e-12 * np.eye(len(names)))
        compare_evolutions(device, 'f32 NS device loop', evolve,
                           sampler.live_u[:evolve.n],
                           float(np.percentile(live_logl, 25)), 2.0, chol,
                           5, 1, rtol=F32_EVOLVE_LOGL_RTOL)

        # --- NS, host loop, through `cli sample`
        ini = sampler_ini(fit_ini, out / 'ns32_host', 'NestedJax',
                          {**goldens['settings'], 'device_loop': False,
                           'max_iters': NS_HOST_ITERATIONS})
        host_s = []
        with timed_method(NestedSampler, '_slice_evolve', device, host_s):
            status = cli.main(['sample', str(ini), '--device', str(device)])
        iterations = int(read_stats(out / 'ns32_host')['num_iterations'])
        chain = np.loadtxt(out / 'ns32_host' / 'chain.txt')
        log(f'f32 NS host loop (cli sample, device_loop = False): '
            f'{iterations} iterations, s per iteration '
            f'{", ".join(f"{t:.4f}" for t in host_s)} (f64 median '
            f'{F64_CAMPAIGNS["ns_host_s"]:.4f}), chain {chain.shape}')
        if status != 0 or len(host_s) != NS_HOST_ITERATIONS \
                or iterations != NS_HOST_ITERATIONS \
                or not np.all(np.isfinite(chain)):
            fail('cli sample did not run the f32 NS host loop')

        # --- SMC
        ini = sampler_ini(fit_ini, out / 'smc32', 'PocoMC',
                          {**SMC_SETTINGS, 'resume': False})
        vega, sampler, result, seconds = run_sampler_script(
            device, ini, 'f32 SMC', SMCSampler)
        mean, std = weighted_moments(result['samples'], result['weights'])
        f64 = F64_CAMPAIGNS['smc']
        log(f'f32 SMC: {read_stats(out / "smc32")["num_stages"]} stages (f64 '
            f'{f64["stages"]}), logZ = {result["logz"]:.4f} (f64 '
            f'{f64["logz"]:.4f}), {seconds:.3f} s (f64 {f64["seconds"]:.3f} '
            's)')
        check_chain('f32 SMC', vega, out / 'smc32', names,
                    vega.sample_params['limits'])
        f32_posterior_gate('f32 SMC', names, mean, std, f64)
        if not np.isfinite(result['logz']):
            fail('f32 SMC logZ is not finite')

        # --- HMC on the payload, then in the dense regime
        for regime, settings in (('grid', HMC_GRID_SETTINGS),
                                 ('dense', HMC_DENSE_SETTINGS)):
            ini = sampler_ini(fit_ini, out / f'hmc32_{regime}', 'HMC',
                              settings)
            LAUNCHES.clear()
            REPLAYED.clear()
            with recorded_launches() as layouts, switch(
                    'VEGA_TPU_FACTORED', '0' if regime == 'dense' else None):
                vega, sampler, result, seconds = run_sampler_script(
                    device, ini, f'f32 HMC {regime}', HMC)
            path = f'f32_hmc_{regime}'
            launches[path], replays[path] = dict(LAUNCHES), dict(REPLAYED)
            f32_launches(f'f32 HMC {regime}', launches[path])
            if regime == 'dense':
                launched_at_chains('the f32 dense HMC run', layouts,
                                   sampler.num_chains, 'f32')
            if sampler.dtype != torch.float32 or not isinstance(
                    sampler._step, GraphedStep):
                fail(f'f32 HMC {regime} did not run in f32 as a CUDA graph')
            f64 = F64_CAMPAIGNS[f'hmc_{regime}']
            trajectory_s, eager_s = hmc_trajectory_times(
                device, f'f32 HMC {regime}', sampler, result,
                atol=F32_TRAJECTORY_ATOL)
            log(f'f32 HMC {regime}: settings {settings}; run {seconds:.3f} s '
                f'(f64 {f64["seconds"]:.3f} s), acceptance '
                f'{result["accept_rate"]:.3f}, step {result["step_size"]:.4g}'
                f', split-R-hat {result["r_hat"].tolist()}; one trajectory '
                f'replayed {trajectory_s:.4f} s (f64 {f64["trajectory_s"]:.4f}'
                f' s, f32 / f64 {trajectory_s / f64["trajectory_s"]:.3f}); '
                f'kernel launches {launches[path]}, of them from graph '
                f'replays {replays[path]}')
            if not 0.5 < result['accept_rate'] <= 1.0:
                fail(f'f32 HMC {regime} acceptance {result["accept_rate"]:.3f}'
                     ' outside (0.5, 1]')
            if regime == 'grid' and not np.max(result['r_hat']) < 1.1:
                fail('f32 HMC grid max split-R-hat >= 1.1')
            if regime == 'dense' and not replays[path].get(('Ft', 0, 'f32')):
                fail('the f32 dense HMC run replayed no captured f32 Ft_0')
            if not np.all(np.isfinite(result['samples'])):
                fail(f'the f32 HMC {regime} chain is not finite')
            mean, std = weighted_moments(result['samples'],
                                         np.ones(len(result['samples'])))
            # the dense run's 20 + 20 trajectories from starts far in the
            # tails are a kernel path, not a posterior (its f64 run's
            # moments are not held either)
            f32_posterior_gate(f'f32 HMC {regime}', names, mean, std, f64,
                               enforce=regime == 'grid')
            checks += check_launches(device, path, layouts)

        # --- the Monte-Carlo scripts: `cli mc`, then run_vega_mc_fits
        mc_scripts(out, fit_ini, 'f32', F32_MC_SCRIPT_MOCKS, cli_device=device,
                   dtype='float32')
    run_hmc_hook(device, out, dtype=torch.float32)

    # --- the f32 dense log-likelihood's evolution as a CUDA graph
    LAUNCHES.clear()
    REPLAYED.clear()
    with recorded_launches() as layouts:
        evolve = DeviceEvolve(BatchedLikelihood(vega), names,
                              vega.sample_params['limits'], *NS_DENSE_SHAPE,
                              seed=0)
        captured = len(evolve.graph.launches)
        lo = np.array([vega.sample_params['limits'][n][0] for n in names])
        hi = np.array([vega.sample_params['limits'][n][1] for n in names])
        start = (result['samples'][-NS_DENSE_SHAPE[0]:] - lo) / (hi - lo)
        l_min = float(np.median(vega.log_lik_batch(dict(zip(
            names, result['samples'][-NS_DENSE_SHAPE[0]:].T))).cpu()
            .numpy()))
        compare_evolutions(device, 'f32 NS dense evolution', evolve, start,
                           l_min, 2.0, 1e-4 * np.eye(len(names)), 3, 2,
                           rtol=F32_EVOLVE_LOGL_RTOL)
    launches['f32_ns_dense'] = dict(LAUNCHES)
    replays['f32_ns_dense'] = dict(REPLAYED)
    f32_launches('f32 NS dense evolution', launches['f32_ns_dense'])
    replayed = REPLAYED.get(('F', 0, 'f32'), 0)
    log(f'f32 NS dense evolution: {captured} combine launches in the graph, '
        f'{replayed} f32 F_0 launches from 3 replays')
    if not captured or replayed != 3 * sum(
            record.launches for key, record in
            evolve.graph.launches.layouts.items() if key[:2] == ('F', 0)):
        fail('the f32 dense evolution\'s replays did not count its captured '
             'f32 F_0 launches')
    checks += check_launches(device, 'f32_ns_dense', layouts)
    return checks


def run_f32_campaigns_path(device, work, fit_ini, f32):
    """Phase f32_campaigns (see the module docstring): the f32 mode in the
    scan, the mock fits and the samplers, on the f32 phase's interfaces
    (`f32`: {'dense', 'grid'}) and against the f64 runs of the scan, mc
    and samplers phases (F64_CAMPAIGNS). Returns the kernel launches of
    its runs, the launches of them that graph replays made, and the
    kernel checks at their layouts."""
    t_phase = time.perf_counter()
    grid = f32['grid']
    launches, replays = {}, {}
    checks = run_f32_scan(device, grid, launches)
    checks += run_f32_mock_fits(device, grid, launches)
    checks += run_f32_samplers(device, fit_ini, grid,
                               Path(work) / 'samplers32', launches, replays)
    log(f'f32_campaigns phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, replays, checks


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
    F64_DENSE_RATES['dr16'] = BATCH / float(np.median(times))
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
        # vega_tpu's fits held as the port's minima (fits from the start
        # took 4.2 and 4.4 s for 122 and 97 calls)
        check_golden_minimum('dr16 grid', device, grid_vega, names,
                             goldens['fit_grid'], 'grid')
        dense = derivatives_at(device, dense_vega, points, names,
                               'dr16 fit dense regime')
        compare_derivatives(
            'dr16 fit dense regime vs JAX dense goldens', dense,
            goldens['dense'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_DENSE_RTOL))
        check_golden_minimum('dr16 dense', device, dense_vega, names,
                             goldens['fit_dense'], 'dense')
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
        fail('the dr16 derivatives launched no F_d or no Ft_d from '
             'metals.py')
    log(f'dr16 phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# ----------------------------------------------------------------------
# The reference's own model terms: UV fluctuations and shotnoise, the
# relativistic and asymmetry terms, Croom's evolution, and the variants
# ----------------------------------------------------------------------
UV_ROUNDS = 2
# the variants the uv phase evaluates on the card: the two that launch
# the combine at a layout or knot grid of their own (one table; the
# extrapolated knots). HeII and the split bias evolution change the
# model's factors only, and tests/test_torch_model_terms.py holds them
# against vega_tpu on the CPU (all four ran here until the f32_campaigns
# phase was added: 5.8 and 6.8 s)
UV_CARD_VARIANTS = ('single_multipole', 'fht_extrap')


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


def uv_rows(params, names):
    """BATCH rows 1% around the configuration's values, the shotnoise
    amplitude (0 there) 1e-4 around it; seed 0."""
    rng = np.random.default_rng(0)
    spread = {n: 0.01 * abs(v) for n, v in params.items()}
    spread['uv_shotnoise_amp'] = 1e-4
    return {n: params[n] + spread[n] * rng.normal(size=BATCH) for n in names}


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
    batches = uv_rows(dense_vega.params, names)
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
    F64_DENSE_RATES['uv'] = rate
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
        check_golden_minimum('uv dense', device, dense_vega, names,
                             goldens['fit_dense'], 'dense')
    launches['uv_fit'] = dict(LAUNCHES)
    checks += check_launches(device, 'uv_fit', layouts)
    legacy_ft = sum(r.launches for key, r in layouts.items()
                    if key[0] == 'Ft' and key[3] == 2)
    log(f'uv fit kernel launches: {launches["uv_fit"]}; Ft_d of two tables '
        f'(the relativistic and asymmetry terms\' backward): {legacy_ft}')
    if not legacy_ft:
        fail('the uv dense derivatives launched no Ft_d of the legacy '
             'terms')

    # --- the variants, one dense evaluation each: counts from zero
    variant_grids = {}
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        point = {k: np.asarray([v])
                 for k, v in goldens['variant_point'].items()}
        for label in UV_CARD_VARIANTS:
            entry = goldens['variants'][label]
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
    F64_DENSE_RATES['desi'] = BATCH / float(np.median(times))
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
        # vega_tpu's dense fit held as the port's minimum (a fit from the
        # start took 20-31 s for 254-343 calls)
        check_golden_minimum('desi dense', device, dense_vega, names,
                             goldens['fit_dense'], 'joint')
        # the mock's initial fit: vega_tpu's, whose best fit the goldens'
        # mock is drawn around
        best = dict(zip(names, goldens['fit_dense']['values']))
        dense_vega.minimize = lambda: setattr(
            dense_vega, 'minimizer', types.SimpleNamespace(values=best))
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
        check_golden_minimum('desi mock', device, dense_vega, names,
                             goldens['fit_mock'], 'joint')
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
# The likelihood options: blinded DESI data written by BuildConfig,
# use_full_pk_for_mc, model_pk, data-free correlations, profiling
# ----------------------------------------------------------------------
INI_HEADER = re.compile(r'^# (File written on|vega_tpu(_torch)? git hash:) '
                        r'.*$', re.MULTILINE)


def config_texts(out_dir, desi_dir):
    """{file name: text} of the ini files BuildConfig wrote into
    `out_dir`, the date and git-hash lines blanked and the two
    directories replaced by '<out>' and '<desi>', as
    tests/tools/make_torch_port_options_goldens.py keeps vega_tpu's."""
    return {p.name: INI_HEADER.sub('#', p.read_text())
            .replace(str(out_dir), '<out>').replace(str(desi_dir), '<desi>')
            for p in sorted(Path(out_dir).glob('*.ini'))}


def raised(fn):
    """The name of the exception fn() raises (None if it returns): the
    data-free interface's calls are expected to raise as vega_tpu's do."""
    try:
        fn()
    except Exception as exc:
        return type(exc).__name__
    return None


def run_options_desi_dr3(device, work, want, blind_seeds, launches, checks):
    """Part (a) of the options phase: synthetic-desi-dr3-full."""
    from vega_tpu_torch.build_config import BuildConfig
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import (with_blinding,
                                        write_desi_example_configs)
    from vega_tpu_torch.vega_interface import VegaInterface

    desi_dir = Path(work) / 'desi'
    out = Path(work) / 'options' / 'desi_dr3'
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    files = {
        'auto': with_blinding(desi_dir / 'cf_synthetic.fits', 'desi_dr3',
                              out / 'cf_desi.fits', seed=blind_seeds['auto']),
        'cross': with_blinding(desi_dir / 'xcf_synthetic.fits', 'desi_dr3',
                               out / 'xcf_desi.fits',
                               seed=blind_seeds['cross'], flip_rp=True),
        'stack': desi_dir / 'delta_stack.fits',
        'catalog': desi_dir / 'qso_catalog.fits',
        'template': desi_dir / 'fiducial_eh98.fits'}
    main = write_desi_example_configs(BuildConfig, out, files)
    texts = config_texts(out, desi_dir)
    log(f'options desi_dr3: blinded copies and BuildConfig\'s configs '
        f'{sorted(texts)} in {time.perf_counter() - t0:.2f} s')
    if texts != want['configs']:
        fail('options desi_dr3: the port\'s BuildConfig files differ from '
             'vega_tpu\'s in ' + str(sorted(
                 n for n in set(texts) | set(want['configs'])
                 if texts.get(n) != want['configs'].get(n))))
    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        vega = VegaInterface(main, device=device)
    names = want['names']
    log(f'options desi_dr3: interface in {time.perf_counter() - t0:.2f} s, '
        f'{len(names)} names sampled, blind {vega._blind}, offsets '
        f'{vega._rnsps}')
    if sorted(vega.sample_params['limits']) != sorted(names):
        fail(f'options desi_dr3 samples {sorted(vega.sample_params["limits"])}')
    if not vega._blind or vega._rnsps is not None:
        fail('options desi_dr3: the interface is not blinded as vega_tpu\'s')
    for name, path in (('lyaxlya', files['auto']),
                       ('lyaxqso', files['cross'])):
        if not (vega.data[name].blind and np.array_equal(
                vega.data[name].data_vec, read_fits(path)[1]['DA_BLIND'])):
            fail(f'options desi_dr3: {name} does not read DA_BLIND')

    # the dense regime: counts from zero
    seen = watch_metals(vega)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        got = vega.chi2_batch(want['params']).cpu().numpy()
        batches = desi_rows(vega.params, names, BATCH,
                            np.random.default_rng(0))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        chi2 = vega.chi2_batch(batches).cpu().numpy()
        first_s = time.perf_counter() - t0
        for name in batches:
            batches[name] = batches[name] + 1e-9
        t0 = time.perf_counter()
        vega.chi2_batch(batches).cpu()
        timed_s = time.perf_counter() - t0
    launches['options_desi_dr3_dense'] = dict(LAUNCHES)
    blinded = np.asarray(want['chi2_blinded'])
    rel = float(np.max(np.abs(got - blinded) / np.abs(blinded)))
    shift = got - np.asarray(want['chi2_unblinded'])
    jax_shift = blinded - np.asarray(want['chi2_unblinded'])
    log(f'options desi_dr3 dense chi2 on DA_BLIND vs JAX goldens '
        f'({len(got)} points): max relative diff {rel:.3e}; moved from the '
        f'unblinded chi2 by [{shift.min():.6g}, {shift.max():.6g}] (JAX '
        f'[{jax_shift.min():.6g}, {jax_shift.max():.6g}])')
    if not rel <= GOLDEN_RTOL:
        fail(f'options desi_dr3 dense chi2 differs from the JAX goldens by '
             f'{rel:.3e}')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)) \
            or np.any(chi2 >= 1e100):
        fail('options desi_dr3 chi2_batch is not finite without a penalty')
    log(f'options desi_dr3 dense chi2_batch({BATCH}): first call '
        f'{first_s:.3f} s, then {BATCH / timed_s:.1f} evals/s ({timed_s:.4f} '
        f's), chi2 in [{chi2.min():.6g}, {chi2.max():.6g}], kernel launches '
        f'{launches["options_desi_dr3_dense"]}, '
        f'{metal_launches(seen, "F")} of F_0 from the metal stacks')
    if not metal_launches(seen, 'F'):
        fail('the options desi_dr3 dense path launched no F_0 from '
             'metals.py')
    checks += check_launches(device, 'options_desi_dr3_dense', layouts)

    # the fit from vega_tpu's best fit moved by FIT_START_SIGMAS of its
    # errors per name (its minimum sits on L0_hcd's limit, which
    # check_golden_minimum refuses; from the [sample] start the fit took
    # 21.4 s for 256 calls): counts from zero
    vega.sample_params['values'].update(shifted_start(vega, names,
                                                      want['fit']))
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        timed_fit(device, vega, 'options desi_dr3 dense')
        check_fit('options desi_dr3 dense', 'blinded', vega, names,
                  want['fit'])
    launches['options_desi_dr3_fit'] = dict(LAUNCHES)
    counts = launches['options_desi_dr3_fit']
    log(f'options desi_dr3 fit kernel launches: {counts}')
    if not (any(n for (p, d), n in counts.items() if d >= 1)
            and any(n for (p, _), n in counts.items() if p == 'Ft')):
        fail('the options desi_dr3 fit launched no kernel of order d >= 1 '
             'or no transpose')
    checks += check_launches(device, 'options_desi_dr3_fit', layouts)


def option_inis(work):
    """The option inis on phase mc's files (work/mc/main.ini), written
    into work/options: direct.ini (use_full_pk_for_mc, no [sample]),
    model_pk.ini and data_free.ini (each correlation's ini copied with
    has_datafile = False). Phases options and f32_options read them."""
    from vega_tpu_torch.testing import with_control, with_sample
    mc_ini = Path(work) / 'mc' / 'main.ini'
    options = Path(work) / 'options'
    options.mkdir(parents=True, exist_ok=True)
    inis = {'direct': options / 'direct.ini',
            'model_pk': options / 'model_pk.ini',
            'data_free': options / 'data_free.ini'}
    with_control(with_sample(mc_ini, {}, inis['direct']),
                 'use_full_pk_for_mc = True', inis['direct'])
    with_control(mc_ini, 'model_pk = True', inis['model_pk'])
    text = mc_ini.read_text()
    for ini in re.findall(r'^ini files = (.*)$', text, re.MULTILINE
                          )[0].split():
        copy = options / f'data_free_{Path(ini).name}'
        copy.write_text(Path(ini).read_text().replace(
            '[data]\n', '[data]\nhas_datafile = False\n', 1))
        text = text.replace(ini, str(copy))
    inis['data_free'].write_text(text)
    return inis


def run_options_path(device, work, card):
    """Phase options (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
    from vega_tpu_torch import profiling
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import MonteCarloEngine
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(OPTIONS_GOLDENS.read_text())
    t_phase = time.perf_counter()
    launches, checks = {}, []
    run_options_desi_dr3(device, work, goldens['desi_dr3'],
                         goldens['blind_seeds'], launches, checks)
    log(f'options desi_dr3: {time.perf_counter() - t_phase:.1f} s')

    # (b) use_full_pk_for_mc on the mc phase's files: no [sample], so no
    # initial fit; counts from zero
    t0 = time.perf_counter()
    inis = option_inis(work)
    options = Path(work) / 'options'
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        vega = VegaInterface(inis['direct'], device=device)
    want = goldens['direct']
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        fiducial = vega.get_fiducial_for_monte_carlo(print_func=log)
        fiducial_ms = 1e3 * (time.perf_counter() - t1)
        engine = MonteCarloEngine(vega)
        sample = {key: {n: vega.mc_config['sample'][key][n]
                        for n in want['mocks']['names']}
                  for key in ('limits', 'values', 'errors', 'fix')}
        mocks = engine.generate_mocks(fiducial, OPTIONS_MOCKS, seed=MC_SEED)
        fits = timed_mock_fits(device, engine, mocks, sample, OPTIONS_MOCKS,
                               'options use_full_pk_for_mc mocks')
        if not np.mean(fits['valid']) >= 0.9:
            fail(f'options use_full_pk_for_mc: only '
                 f'{np.mean(fits["valid"]):.3f} of the fits are valid')
        golden_mocks = numpy_mocks(vega, fiducial, want['mocks']['n_mocks'],
                                   want['mocks']['seed'])
        got = timed_mock_fits(device, engine, golden_mocks, sample,
                              DEFAULT_FIT_CHUNK,
                              'options use_full_pk_for_mc golden')
        check_mock_fits('options use_full_pk_for_mc', got, want['mocks'])
    launches['options_direct'] = dict(LAUNCHES)
    worst = max(rel_err(fiducial[n], want['fiducial'][n])
                for n in want['fiducial'])
    log(f'options use_full_pk_for_mc: fiducial (compute_direct at '
        f'{vega.mc_config["params"]}) in {fiducial_ms:.1f} ms against the '
        f'JAX fiducial {worst:.3e} of max|ref|; kernel launches '
        f'{launches["options_direct"]}; the phase so far '
        f'{time.perf_counter() - t0:.1f} s')
    if not worst <= OPTION_MODEL_RTOL:
        fail(f'options use_full_pk_for_mc: the fiducial differs from the '
             f'JAX one by {worst:.3e} of max|ref|')
    if not launches['options_direct'].get(('F', 0)):
        fail('options use_full_pk_for_mc launched no F_0')
    checks += check_launches(device, 'options_direct', layouts)

    # (e) profiling.time_likelihood on synthetic-full's interface
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        stats = profiling.time_likelihood(vega, n_evals=PROFILE_EVALS)
        with profiling.trace(options / 'trace', device) as prof:
            vega.chi2()
    launches['options_profiling'] = dict(LAUNCHES)
    checks += check_launches(device, 'options_profiling', layouts)
    device_us = sum(getattr(e, 'self_device_time_total',
                            getattr(e, 'self_cuda_time_total', 0))
                    for e in prof.key_averages())
    log(f'options profiling.time_likelihood (synthetic-full, dense chi2 at '
        f'one point, {PROFILE_EVALS} calls): first call '
        f'{stats["first_call_s"]:.4f} s, steady {stats["evals_per_sec"]:.1f}'
        f' evals/s, chi2 {stats["chi2"]!r}, on {card}; profiling.trace of '
        f'one chi2: {device_us / 1e3:.4f} ms of device time in its table')
    del vega

    # (c) model_pk on the same files
    t0 = time.perf_counter()
    vega = VegaInterface(inis['model_pk'], device=device)
    LAUNCHES.clear()
    multipoles = vega.compute_model(run_init=False)
    launches['options_model_pk'] = dict(LAUNCHES)
    if {n: m.shape for n, m in multipoles.items()} != {
            n: np.shape(m) for n, m in goldens['model_pk'].items()}:
        fail('options model_pk: the multipoles are not of the JAX shapes')
    worst = max(rel_err(multipoles[n], goldens['model_pk'][n])
                for n in goldens['model_pk'])
    log(f'options model_pk: multipoles '
        f'{ {n: m.shape for n, m in multipoles.items()} } in '
        f'{time.perf_counter() - t0:.2f} s (interface included) against the '
        f'JAX ones {worst:.3e} of max|ref|; kernel launches '
        f'{launches["options_model_pk"]}')
    if not worst <= OPTION_MODEL_RTOL:
        fail(f'options model_pk differs from the JAX multipoles by '
             f'{worst:.3e} of max|ref|')
    del vega

    # (d) correlations without a data file
    vega = VegaInterface(inis['data_free'], device=device)
    want = goldens['data_free']
    got = {'has_data': vega._has_data,
           'data': {n: d is None for n, d in vega.data.items()},
           'models': sorted(vega.models), 'plots': vega.plots is None,
           'corr_num_marg_modes': vega.corr_num_marg_modes,
           'raises': {
               'compute_model': raised(
                   lambda: vega.compute_model({'bias_LYA': -0.11})),
               'compute_model_no_init': raised(lambda: vega.compute_model(
                   {'bias_LYA': -0.11}, run_init=False)),
               'chi2': raised(lambda: vega.chi2({'bias_LYA': -0.11})),
               'chi2_batch': raised(lambda: vega.chi2_batch(
                   {'bias_LYA': np.array([-0.11, -0.12])}))}}
    log(f'options data-free: {got} (JAX {want})')
    if got != want:
        fail('options data-free: the interface does not do what '
             'vega_tpu\'s does')
    log(f'options phase: {time.perf_counter() - t_phase:.1f} s')
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


def mc_scripts(work, fit_ini, label, n_mocks, cli_device=None,
               dtype='float64'):
    """run_vega_mc.main([ini]) (with `cli_device`, `cli mc ini --device
    cli_device`) then run_vega_mc_fits.main([ini']) on the MOCKS it
    wrote: the fit configuration with [monte carlo] (bias_LYA, beta_LYA,
    served by the nuisance collapse) and num_mc_mocks = n_mocks; the two
    Bestfit tables within MC_TABLE_RTOL (the same mocks, read back in the
    dtype they were written in, fitted again), both written in
    `dtype`."""
    from vega_tpu_torch import cli
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.scripts import run_vega_mc, run_vega_mc_fits
    from vega_tpu_torch.vega_interface import parse_ini
    work = Path(work) / f'{label}_mc'
    work.mkdir()
    config = parse_ini(fit_ini)
    config['control'].update({'run_montecarlo': 'True',
                              'num_mc_mocks': str(n_mocks),
                              'mc_seed': '0'})
    config['output']['filename'] = str(work / 'output')
    config['monte carlo'] = {n: config['sample'][n]
                             for n in ('bias_LYA', 'beta_LYA')}
    config['mc parameters'] = {'bias_LYA': '-0.117', 'beta_LYA': '1.67'}
    ini = work / 'main_mc.ini'
    with open(ini, 'w') as fh:
        config.write(fh)
    t0 = time.perf_counter()
    if cli_device is None:
        run_vega_mc.main([str(ini)])
    else:
        cli.main(['mc', str(ini), '--device', str(cli_device)])
    mc_s = time.perf_counter() - t0
    mocks_file = work / 'monte_carlo' / 'monte_carlo.fits'
    config['control']['mc_mocks'] = str(mocks_file)
    config['output']['mc_output'] = str(work / 'refit')
    refit_ini = work / 'main_refit.ini'
    with open(refit_ini, 'w') as fh:
        config.write(fh)
    t0 = time.perf_counter()
    run_vega_mc_fits.main([str(refit_ini)] + (
        [] if cli_device is None else ['--device', str(cli_device)]))
    refit_s = time.perf_counter() - t0

    def table(path):
        return {h.name: h for h in read_fits(path)
                if getattr(h, 'name', '')}['Bestfit']
    first, second = table(mocks_file), table(work / 'refit' /
                                             'monte_carlo.fits')
    values = np.asarray(first['values'])
    if values.shape != (2, n_mocks) or not np.all(
            np.isfinite(values)) or values.dtype != dtype:
        fail(f'run_vega_mc Bestfit values of shape {values.shape} and '
             f'dtype {values.dtype}')
    worst = max(float(np.max(np.abs(np.asarray(second[col])
                                    - np.asarray(first[col]))
                             / np.abs(np.asarray(first[col]))))
                for col in ('values', 'errors'))
    log(f'{label} Monte-Carlo scripts: '
        + ('run_vega_mc' if cli_device is None else 'cli mc')
        + f' {mc_s:.2f} s '
        f'({n_mocks} mocks, initial fit included), '
        f'run_vega_mc_fits {refit_s:.2f} s on its MOCKS, Bestfit in '
        f'{values.dtype}; values '
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
    F64_DENSE_RATES['marg'] = mock_dense_regime(
        device, 'marg', dense_vega, cov_goldens, launches, checks, hooks={
            'metal matrices': [(m.metals, 'apply_metal_matrix')
                               for m in models],
            'metal combine': [(metals_mod, 'spline_legendre_combine')],
            'power-spectrum grids': [(m.Pk_core, 'compute_peak_smooth')
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
    F64_ROUTE_CHI2['table6'] = grid
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
    mc_scripts(work, fit_ini, 'table6', TABLE6_MC_MOCKS)
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
    F64_DENSE_RATES['dr16pub'] = dense_rate
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
        F64_ROUTE_CHI2['dr16pub'] = grid
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

    # --- where the route's minimum lies against the JAX dense fit (the
    # dense fit is run_vega's): the Newton step from the JAX dense best
    # fit on the route, in place of a fit in it
    want = goldens['fit_dense']
    point = dict(zip(names, want['values']))
    t0 = time.perf_counter()
    value, grad = vega.chi2_value_and_gradient(point)
    hess = vega.chi2_hessian(point, list(names))
    torch.cuda.synchronize(device)
    h = np.array([[hess[a][b] for b in names] for a in names])
    step = np.linalg.solve(h, np.array([grad[n] for n in names]))
    d_sigma = float(np.max(np.abs(step) / np.asarray(want['errors'])))
    log(f'dr16pub grid route at the JAX dense best fit '
        f'({time.perf_counter() - t0:.3f} s: value, gradient, Hessian): '
        f'chi2 {value!r} (the JAX dense fit\'s {want["fval"]!r}); the '
        f'Newton step to the route\'s minimum {d_sigma:.3e} JAX errors; '
        'reported, not enforced')
    log(f'dr16pub phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


# ----------------------------------------------------------------------
# The f32 throughput mode on the eBOSS DR16 and DESI configurations
# ----------------------------------------------------------------------
F32_MODELS = ('dr16', 'desi', 'dr16pub')
# one timed round of each dense f32 chi2_batch(8192) in the f32_models and
# f32_terms phases: the f64 phase's rate of the same run is the yardstick
F32_ROUNDS = 1
# the f64 phases' numbers of this run that the f32_models phase reads:
# dense chi2_batch(8192) evals/s by configuration, and dr16pub's f64
# route chi^2 at its goldens' points
F64_DENSE_RATES = {}
F64_ROUTE_CHI2 = {}


def f32_model_files(device, work, name):
    """(main ini, grid ini) of the configuration the f64 phase `name`
    wrote under `work`, written here with the same arguments when that
    phase did not run (the phase alone); desi's grid ini without the
    joint covariance."""
    from vega_tpu_torch.testing import (DESI_METALS, DR16_METALS,
                                        desi_extra_model, dr16_extra_model,
                                        make_dr16_published_dataset,
                                        make_synthetic_dataset)
    root = Path(work) / name
    main_ini = root / 'main.ini'
    if not main_ini.exists():
        if name == 'dr16':
            make_synthetic_dataset(
                root, cross=True, size='full', device=device,
                sample=json.loads(DR16_GOLDENS.read_text())['sample'],
                extra_model=dr16_extra_model(), metals=list(DR16_METALS))
        elif name == 'desi':
            goldens = json.loads(DESI_GOLDENS.read_text())
            make_synthetic_dataset(
                root, cross=True, size='full', device=device,
                sample=goldens['sample'], extra_model=desi_extra_model(),
                metals=list(DESI_METALS), new_metals=True, global_cov=True,
                extra_control=goldens['extra_control'])
        else:
            make_dr16_published_dataset(root, size='full', device=device)
    if name != 'desi':
        return main_ini, main_ini
    # per-correlation covariances: the files without the joint one
    grid_ini = root / 'main_f32_grid.ini'
    grid_ini.write_text(re.sub(r'global-cov-file = .*\n', '\n',
                               main_ini.read_text()))
    return main_ini, grid_ini


def f32_models_hold(label, got, jax32, jax64):
    """The port's f32 chi^2 against vega_tpu's f64 (enforced) and its
    f32 (enforced where vega_tpu's own f32 is within the ladder of its
    f64; else its gap is printed and the port is held to f64 alone)."""
    f32_ladder(f'{label} vs vega_tpu\'s f64', got, jax64)
    jax32, jax64 = np.asarray(jax32, float), np.asarray(jax64, float)
    gap = np.abs(jax32 - jax64)
    jax_within = bool(np.all(gap <= np.maximum(F32_CHI2_ABS,
                                               F32_CHI2_REL * np.abs(jax64))))
    if not jax_within:
        log(f'{label}: vega_tpu\'s own f32 misses its f64 by up to '
            f'{gap.max():.4g}, outside the ladder: the port is held to '
            'vega_tpu\'s f64, and its gap to vega_tpu\'s f32 is reported')
    f32_ladder(f'{label} vs vega_tpu\'s f32', got, jax32,
               enforce=jax_within)


def check_f32_route(name, got, route64, dense64):
    """The f32 route of dr16pub or table6, for which vega_tpu has no
    route goldens, against the f64 route of phase `name` in the same run:
    the ladder reported, and enforced that f32 adds at most
    F32_ROUTE_SHARE of the route's own distance from the JAX f64 dense
    chi^2 (the sigma_velo node convergence, ROADMAP.md section 3). On a
    4-dimension payload the interpolated data term s(g) loses ~3e-4 of
    chi^2 in f32 (its Chebyshev coefficients sum to ~1e4 x s; ROADMAP.md
    section 3)."""
    f32_ladder(f'f32 {name} grid route vs vega_tpu\'s f64 dense', got,
               dense64, enforce=False)
    if route64 is None:
        log(f'f32 {name} grid route: phase {name} did not run, no f64 route '
            'to hold it to')
        return
    f32_ladder(f'f32 {name} grid route vs the f64 route of phase {name}',
               got, route64, enforce=False)
    own = np.abs(np.asarray(route64) - np.asarray(dense64))
    share = float(np.max(np.abs(np.asarray(got) - np.asarray(route64))
                         / own))
    log(f'f32 {name} grid route: |f32 - f64 route| at most {share:.3e} of '
        f'the f64 route\'s own distance from the dense chi2 ('
        + ', '.join(f'{d:.4g}' for d in own) + f'); gate {F32_ROUTE_SHARE:g}')
    if not share <= F32_ROUTE_SHARE:
        fail(f'f32 {name} grid route adds {share:.3e} of the route\'s own '
             f'error to it, > {F32_ROUTE_SHARE:g}')


def run_f32_models_path(device, work, card):
    """Phase f32_models (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens32 = json.loads(F32_MODELS_GOLDENS.read_text())['full']
    sources = {'dr16': DR16_GOLDENS, 'desi': DESI_GOLDENS,
               'dr16pub': DR16PUB_GOLDENS}
    t_phase = time.perf_counter()
    launches, checks = {}, []
    for name in F32_MODELS:
        t_config = time.perf_counter()
        goldens = json.loads(sources[name].read_text())
        names = goldens['names']
        points = goldens.get('params', goldens.get('points'))
        jax32 = goldens32[name]['f32']
        if 'chi2' not in jax32:
            fail(f'f32 {name}: vega_tpu\'s f32 goldens hold no chi^2 '
                 f'({jax32})')
        main_ini, grid_ini = f32_model_files(device, work, name)
        t0 = time.perf_counter()
        with switch('VEGA_TPU_FACTORED', '0'), switch('VEGA_TPU_X64', '0'):
            dense = VegaInterface(main_ini, device=device)
        if dense.dtype != torch.float32:
            fail(f'f32 {name}: VEGA_TPU_X64=0 gave {dense.dtype}')
        log(f'f32 {name} dense: interface in {time.perf_counter() - t0:.2f} '
            's')
        rng = np.random.default_rng(0)
        batches = desi_rows(dense.params, names, BATCH, rng)

        # --- dense chi2_batch(8192): counts from zero
        seen = watch_metals(dense)
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            chi2 = dense.chi2_batch(batches)
            torch.cuda.synchronize(device)
            first_s = time.perf_counter() - t0
        path = f'f32_{name}_dense'
        launches[path] = dict(LAUNCHES)
        f32_only(f'f32 {name} dense', launches[path])
        chi2_np = chi2.cpu().numpy()
        log(f'f32 {name} dense chi2_batch({BATCH}), {len(names)} names: '
            f'{chi2.dtype}, first call {first_s:.3f} s, peak device memory '
            f'{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB, chi2 '
            f'in [{chi2_np.min():.6g}, {chi2_np.max():.6g}], kernel '
            f'launches {launches[path]}, {metal_launches(seen, "F")} of F_0 '
            'from the metal stacks at '
            + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen))
        if chi2.dtype != torch.float32 or not np.all(np.isfinite(chi2_np)):
            fail(f'f32 {name} dense chi2_batch is not a finite float32 '
                 'batch')
        if not metal_launches(seen, 'F'):
            fail(f'f32 {name}: the dense path launched no F_0 from '
                 'metals.py')
        checks += check_launches(device, path, layouts)
        f32_models_hold(f'f32 {name} dense', dense.chi2_batch(
            points).cpu().numpy(), jax32['chi2'], goldens['chi2_dense'])
        times = []
        for _ in range(F32_ROUNDS):
            for n in batches:
                batches[n] = batches[n] + 1e-6
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            dense.chi2_batch(batches)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        rate = BATCH / float(np.median(times))
        f64_rate = F64_DENSE_RATES.get(name)
        log(f'f32 {name} dense chi2_batch({BATCH}): {rate:.1f} evals/s '
            f'(median of {len(times)}, s per call '
            f'{", ".join(f"{t:.4f}" for t in times)}); the f64 phase\'s '
            + ('not measured in this run' if f64_rate is None else
               f'{f64_rate:.1f} evals/s, f32 / f64 {rate / f64_rate:.3f}'))

        # --- the grid route: counts from zero
        grid_names = goldens.get('grid_names', names)
        with switch('VEGA_TPU_FACTORED', None), \
                switch('VEGA_TPU_GRID_COLLAPSE', None), \
                switch('VEGA_TPU_GRID_CACHE', '0'):
            grid = VegaInterface(grid_ini, device=device,
                                 dtype=torch.float32)
            LAUNCHES.clear()
            with recorded_launches() as layouts:
                t0 = time.perf_counter()
                payload = grid.get_collapsed(frozenset(grid_names))
                torch.cuda.synchronize(device)
                collapse_s = time.perf_counter() - t0
                got = grid.chi2_batch({n: points[n] for n in grid_names})
            path = f'f32_{name}_grid'
            launches[path] = dict(LAUNCHES)
            f32_only(f'f32 {name} grid', launches[path])
            checks += check_launches(device, path, layouts)
        got = got.cpu().numpy()
        served = sorted(set(payload) - {'__grid__'})
        log(f'f32 {name} grid route ({len(grid_names)} names): '
            f'{payload["__grid__"]}, serves {served}, cold collapse '
            f'{collapse_s:.3f} s (device sweep '
            f'{grid.grid_stats["sweep_s"]:.3f} s), kernel launches '
            f'{launches[path]}')
        if not np.all(np.isfinite(got)):
            fail(f'f32 {name} grid chi2 is not finite')
        if name == 'dr16pub':
            check_f32_route(name, got, F64_ROUTE_CHI2.get(name),
                            goldens['chi2_dense'])
        else:
            f32_ladder(f'f32 {name} grid vs vega_tpu\'s f64 grid', got,
                       goldens['chi2_grid'])
        del grid

        # --- vega_tpu's f64 dense fit held as the f32 interface's minimum
        # (check_golden_minimum: value, gradient and Hessian there):
        # counts from zero
        seen.clear()
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            check_golden_minimum(f'f32 {name} dense', device, dense, names,
                                 goldens['fit_dense'], 'f32')
        path = f'f32_{name}_fit'
        launches[path] = dict(LAUNCHES)
        f32_only(f'f32 {name} dense fit', launches[path])
        checks += check_launches(device, path, layouts)
        log(f'f32 {name} at the JAX dense best fit: kernel launches '
            f'{launches[path]}')
        counts = launches[path]
        if not (any(n for k, n in counts.items() if k[0] == 'Ft')
                and any(n for k, n in counts.items() if k[1] >= 1)
                and metal_launches(seen, 'F')):
            fail(f'the f32 {name} derivatives at the JAX best fit launched '
                 'no f32 Ft_d, no f32 kernel of order d >= 1, or no F_0 '
                 'from metals.py')
        del dense
        log(f'f32 {name}: {time.perf_counter() - t_config:.1f} s')
    log(f'f32_models phase: {time.perf_counter() - t_phase:.1f} s')
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


def sensitivity_subset(want, names):
    """The goldens' sensitivity summary of `names` alone: their partials
    and the Fisher sums of their pairs (a name's central difference and a
    pair's Fisher information do not depend on the other names)."""
    pairs = {corr: [k for k in sums if set(k.split('|')) <= set(names)]
             for corr, sums in want['fisher_sums'].items()}
    return {'partials': {corr: {n: p[n] for n in names}
                         for corr, p in want['partials'].items()},
            **{key: {corr: {k: want[key][corr][k] for k in pairs[corr]}
                     for corr in want[key]}
               for key in ('fisher_sums', 'fisher_abs_sums')}}


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
    fit_goldens = json.loads(RUN_VEGA_FIT_GOLDENS.read_text())
    names = fit_goldens['names']
    t_phase = time.perf_counter()
    main_ini = make_dr16_published_dataset(
        Path(work) / 'run_vega', size='full', device=device, components=True,
        files_from=Path(work) / 'dr16pub', sample=fit_goldens['sample'])
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

    # the fit starts at vega_tpu's dense best fit moved by
    # FIT_START_SIGMAS of its errors per name (from the config's start the
    # 18-name fit took 71.6-103.0 s)
    def start(vega):
        vega.sample_params['values'].update(shifted_start(
            vega, names, fit_goldens['fit_dense']))

    run_vega.fit_and_write = keep
    try:
        # the dense path: with the metals unrolled vega_tpu's route
        # sweeps a payload that serves no correlation
        with switch('VEGA_TPU_FACTORED', '0'), after_init(start):
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
    log(f'run_vega: cli fit {fit_s:.2f} s (interface, dense fit, results '
        f'file{", plots" if plots else ""}), exit {status}, peak device '
        f'memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB, '
        f'kernel launches {launches["run_vega_fit"]}')
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

    # the other sampled names at the goldens' point, not the run's fit;
    # the first FD_SENSITIVITY_NAMES of the goldens' names (2 rebuilds)
    vega.params.update(goldens['point'])
    fd_names = goldens['fd_names'][:FD_SENSITIVITY_NAMES]
    fd_nominal = {n: nominal[n] for n in fd_names}
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
    check_sensitivity('run_vega compute_sensitivity', vega,
                      sensitivity_subset(goldens['fd'], fd_names),
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


def mock_hooks(name, vega):
    """The parts whose device shares a mock phase reads
    (`device_shares`): desi_mock's metal matrices, the metal stacks'
    combine and the power-spectrum grids (the smoothing among them);
    lyacolore's grids and the combine."""
    import vega_tpu_torch.metals as metals_mod
    from vega_tpu_torch import pktoxi as pktoxi_mod
    models = list(vega.models.values())
    grids = {'power-spectrum grids (smoothing included)': [
        (m.Pk_core, 'compute_peak_smooth') for m in models]}
    if name == 'desi_mock':
        return {'metal matrices': [(m.metals, 'apply_metal_matrix')
                                   for m in models],
                'metal combine': [(metals_mod, 'spline_legendre_combine')],
                **grids}
    return {**grids, 'combine': [(pktoxi_mod, 'spline_legendre_combine')]}


def run_desi_mock_path(device, work, card):
    """Phase desi_mock (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
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
    F64_DENSE_RATES['desi_mock'] = mock_dense_regime(
        device, 'desi_mock', dense_vega, goldens, launches, checks,
        hooks=mock_hooks('desi_mock', dense_vega))

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
    # vega_tpu's grid fit held as the port's minimum (a fit from the start
    # took 6.7 s for 148 calls)
    check_golden_minimum('desi_mock grid', device, grid_vega, grid_names,
                         goldens['fit_grid'], 'grid')
    log(f'desi_mock phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


def run_lyacolore_path(device, work, card):
    """Phase lyacolore (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
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
    F64_DENSE_RATES['lyacolore'] = mock_dense_regime(
        device, 'lyacolore', dense_vega, goldens, launches, checks,
        hooks=mock_hooks('lyacolore', dense_vega))

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


# ----------------------------------------------------------------------
# The f32 mode on every model term: the mocks' smoothing, UV, the
# relativistic and asymmetry pair, Croom, the variants, table6's sweep
# ----------------------------------------------------------------------
F32_TERMS = ('desi_mock', 'lyacolore', 'uv')
F32_TERMS_GOLDENS = (ROOT / 'tests' / 'data'
                     / 'torch_port_f32_terms_goldens.json')
F32_TERMS_UV_VARIANTS = ('uv_single_multipole', 'uv_fht_extrap')


def f32_terms_files(device, work, name):
    """(main ini, grid ini) of the configuration the f64 phase `name`
    wrote under `work` (desi_mock: its main_grid.ini), written here with
    the same arguments when that phase did not run (the phase alone)."""
    from vega_tpu_torch.testing import (DESI_MOCK_FIT_SAMPLE, DR16_METALS,
                                        LYACOLORE_FIT_SAMPLE, TABLE6_SAMPLE,
                                        dr16_extra_model,
                                        make_desi_mock_dataset,
                                        make_dr16_uv_dataset,
                                        make_lyacolore_dataset,
                                        make_synthetic_dataset, with_sample)
    root = Path(work) / name
    main_ini = root / 'main.ini'
    if name == 'desi':
        return f32_model_files(device, work, 'desi')
    if not main_ini.exists():
        if name == 'desi_mock':
            make_desi_mock_dataset(root, size='full', device=device,
                                   sample=DESI_MOCK_FIT_SAMPLE)
        elif name == 'lyacolore':
            make_lyacolore_dataset(root, size='full', device=device,
                                   sample=LYACOLORE_FIT_SAMPLE)
        elif name == 'uv':
            make_dr16_uv_dataset(
                root, size='full', device=device,
                sample=json.loads(UV_GOLDENS.read_text())['sample'])
        else:
            make_synthetic_dataset(
                root, cross=True, size='full', device=device,
                sample=TABLE6_SAMPLE, extra_model=dr16_extra_model(),
                metals=list(DR16_METALS))
    if name != 'desi_mock':
        return main_ini, main_ini
    grid_ini = root / 'main_grid.ini'
    if not grid_ini.exists():
        names = json.loads(MOCKS_GOLDENS.read_text())['desi_mock'][
            'grid_names']
        with_sample(main_ini, {n: DESI_MOCK_FIT_SAMPLE[n] for n in names},
                    grid_ini)
    return main_ini, grid_ini


def f32_variant_files(work, main_ini, label, changes):
    """The variant's main ini under `work` (the f64 phase's copy where it
    wrote one)."""
    from vega_tpu_torch.testing import dataset_variant
    path = Path(work) / label / 'main.ini'
    return path if path.exists() else dataset_variant(
        main_ini, Path(work) / label, **changes)


def f32_terms_dense(device, label, vega, names, points, jax32, jax64,
                    launches, checks, hooks, watch):
    """The dense f32 regime of one configuration, counts from zero:
    chi2_batch(BATCH) with only f32 kernels launched (and, through
    `watch`, {(owner, attribute)} whose launches it must contain), the
    chi^2 at the goldens' points held by `f32_models_hold`, evals/s
    beside the f64 phase's of the same run, and the device shares of
    `hooks`."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    batches = (uv_rows(vega.params, names) if label == 'uv' else
               desi_rows(vega.params, names, BATCH,
                         np.random.default_rng(0)))
    seen = watch_calls(watch)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    path = f'f32_{label}_dense'
    launches[path] = dict(LAUNCHES)
    f32_only(f'f32 {label} dense', launches[path])
    chi2_np = chi2.cpu().numpy()
    log(f'f32 {label} dense chi2_batch({BATCH}), {len(names)} names: '
        f'{chi2.dtype}, first call {first_s:.3f} s, peak device memory '
        f'{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB, chi2 in '
        f'[{chi2_np.min():.6g}, {chi2_np.max():.6g}], kernel launches '
        f'{launches[path]}; of them {metal_launches(seen, "F")} F_0 at '
        + '; '.join(layout_label(k[0], k[1], k[2:]) for k in seen))
    # a penalised f32 row is inf (vega_tpu's 1e100 rounded to f32)
    if chi2.dtype != torch.float32 or not np.all(np.isfinite(chi2_np)):
        fail(f'f32 {label} dense chi2_batch is not a finite float32 batch '
             'without a penalty')
    if not metal_launches(seen, 'F'):
        fail(f'f32 {label} dense: no F_0 launched from {watch}')
    checks += check_launches(device, path, layouts)
    f32_models_hold(f'f32 {label} dense', vega.chi2_batch(points)
                    .cpu().numpy(), jax32, jax64)
    rate, times = timed_rows(device, vega, batches, F32_ROUNDS)
    f64_rate = F64_DENSE_RATES.get(label)
    log(f'f32 {label} dense chi2_batch({BATCH}): {rate:.1f} evals/s (s '
        f'per call {", ".join(f"{t:.4f}" for t in times)}); the f64 '
        'phase\'s ' + ('not measured in this run' if f64_rate is None else
                       f'{f64_rate:.1f} evals/s, f32 / f64 '
                       f'{rate / f64_rate:.3f}'))
    total_ms, parts = device_shares(device, vega, batches, hooks=hooks)
    log(f'f32 {label} dense chi2_batch({BATCH}) on CUDA events: '
        f'{total_ms:.1f} ms; ' + ', '.join(
            f'{key} {ms:.1f} ms ({ms / total_ms:.1%})'
            for key, ms in parts.items())
        + f'; the rest {total_ms - sum(parts.values()):.1f} ms')


def run_f32_terms_path(device, work, card):
    """Phase f32_terms (see the module docstring); returns the kernel
    launches of its paths, the kernel checks at their layouts and the
    edge checks on the uv path's two knot grids in f32."""
    from vega_tpu_torch.gridcollapse import plan_components
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import VegaInterface

    terms = json.loads(F32_TERMS_GOLDENS.read_text())['full']
    mocks = json.loads(MOCKS_GOLDENS.read_text())
    f64_goldens = {'desi_mock': mocks['desi_mock'],
                   'lyacolore': mocks['lyacolore'],
                   'uv': json.loads(UV_GOLDENS.read_text())}
    t_phase = time.perf_counter()
    launches, checks, edges = {}, [], []
    for name in F32_TERMS:
        t_config = time.perf_counter()
        goldens = f64_goldens[name]
        names, points = goldens['names'], goldens['params']
        jax32 = terms[name]['f32']
        if 'chi2' not in jax32:
            fail(f'f32 {name}: vega_tpu\'s f32 goldens hold no chi^2 '
                 f'({jax32})')
        main_ini, grid_ini = f32_terms_files(device, work, name)
        with switch('VEGA_TPU_FACTORED', '0'), switch('VEGA_TPU_X64', '0'):
            dense = VegaInterface(main_ini, device=device)
        if dense.dtype != torch.float32:
            fail(f'f32 {name}: VEGA_TPU_X64=0 gave {dense.dtype}')
        if name == 'uv':
            hooks = {'power-spectrum grids': [
                (m.Pk_core, 'compute_peak_smooth')
                for m in dense.models.values()],
                'metal stacks': [(m.metals, 'compute')
                                 for m in dense.models.values()
                                 if m.metals is not None],
                'relativistic and asymmetry': legacy_targets(dense)}
            watch = legacy_targets(dense)
        else:
            hooks = mock_hooks(name, dense)
            watch = ([(m.metals, 'compute') for m in dense.models.values()]
                     if name == 'desi_mock' else
                     [(m.PktoXi, 'compute') for m in dense.models.values()])
        f32_terms_dense(device, name, dense, names, points, jax32['chi2'],
                        goldens['chi2_dense'], launches, checks, hooks,
                        watch)

        # --- the grid or vega_tpu's route, cold: counts from zero
        grid_names = goldens.get('grid_names', names)
        with switch('VEGA_TPU_FACTORED', None), \
                switch('VEGA_TPU_GRID_COLLAPSE', None), \
                switch('VEGA_TPU_GRID_CACHE', '0'):
            grid = VegaInterface(grid_ini, device=device,
                                 dtype=torch.float32)
            LAUNCHES.clear()
            with recorded_launches() as layouts:
                t0 = time.perf_counter()
                payload = grid.get_collapsed(frozenset(grid_names))
                torch.cuda.synchronize(device)
                collapse_s = time.perf_counter() - t0
                got = grid.chi2_batch({n: points[n] for n in grid_names})
            path = f'f32_{name}_grid'
            launches[path] = dict(LAUNCHES)
            f32_only(f'f32 {name} grid', launches[path])
            checks += check_launches(device, path, layouts)
        got = got.cpu().numpy()
        log(f'f32 {name} grid or route ({len(grid_names)} names): '
            f'{payload.get("__grid__")}, serves '
            f'{sorted(set(payload) - {"__grid__"})}, cold '
            f'{collapse_s:.3f} s, kernel launches {launches[path]}')
        if not np.all(np.isfinite(got)):
            fail(f'f32 {name} grid chi2 is not finite')
        if name == 'desi_mock':
            f32_ladder('f32 desi_mock grid vs vega_tpu\'s f64 grid', got,
                       goldens['chi2_grid'])
            minimum = (grid, grid_names, goldens['fit_grid'])
        elif name == 'uv':
            if sorted(payload) != goldens['route_keys']:
                fail(f'f32 uv route serves {sorted(payload)}, vega_tpu '
                     f'{goldens["route_keys"]}')
            f32_ladder('f32 uv route vs vega_tpu\'s f64 route', got,
                       goldens['chi2_route'])
            minimum = (dense, names, goldens['fit_dense'])
        else:
            if payload != {}:
                fail(f'f32 lyacolore: the route serves {sorted(payload)}, '
                     'vega_tpu\'s nothing')
            f32_ladder('f32 lyacolore route (every call dense) vs '
                       'vega_tpu\'s f64 dense', got, goldens['chi2_dense'])
            minimum = (dense, names, goldens['fit_dense'])

        # --- vega_tpu's f64 fit held as the f32 minimum: counts from zero
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            vega, fit_names, want = minimum
            check_golden_minimum(f'f32 {name}', device, vega, fit_names,
                                 want, 'f32')
        path = f'f32_{name}_fit'
        launches[path] = dict(LAUNCHES)
        if vega is dense:
            f32_only(f'f32 {name} fit', launches[path])
        elif any(len(k) == 2 and n for k, n in launches[path].items()):
            # desi_mock's grid chi^2 and its derivatives read the payload
            # and launch no combine
            fail(f'f32 {name} fit on the payload launched f64 kernels: '
                 f'{launches[path]}')
        checks += check_launches(device, path, layouts)
        log(f'f32 {name} at the JAX best fit: kernel launches '
            f'{launches[path]}')
        if name == 'uv':
            pair_ft = sum(r.launches for key, r in layouts.items()
                          if key[0] == 'Ft' and key[3] == 2)
            pair_d = sum(r.launches for key, r in layouts.items()
                         if key[0] in ('F', 'P') and key[1] >= 1
                         and key[3] == 2)
            log(f'f32 uv fit: Ft_d / F_d (d >= 1), P_d of two tables: '
                f'{pair_ft} / {pair_d}')
            if not pair_ft or not pair_d:
                fail('the f32 uv derivatives launched no Ft_d or no F_d / '
                     'P_d of two tables (the relativistic and asymmetry '
                     'terms\' backward)')
            legacy_grid = dense.models['qsoxlya'].PktoXi.legacy_operators(
                (1, 3), 1)[0]
        del grid, vega, dense
        log(f'f32 {name}: {time.perf_counter() - t_config:.1f} s')

    # --- uv's card variants and desi's rescale-coords-systematics, dense
    # at their goldens' rows: counts from zero
    uv_main = f32_terms_files(device, work, 'uv')[0]
    uv_changes = {f'uv_{label}': entry['changes'] for label, entry in
                  f64_goldens['uv']['variants'].items()}
    # the files first: writing desi's (the phase alone) evaluates its
    # model in f64
    mains = {label: f32_variant_files(work, uv_main, label,
                                      uv_changes[label])
             for label in F32_TERMS_UV_VARIANTS}
    mains['desi_rescale'] = f32_variant_files(
        work, f32_terms_files(device, work, 'desi')[0], 'desi_rescale',
        {'cross': 'rescale-coords-systematics = True\n'})
    variant_grids = {}
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        for label, main in mains.items():
            t0 = time.perf_counter()
            with switch('VEGA_TPU_FACTORED', '0'):
                vega = VegaInterface(main, device=device,
                                     dtype=torch.float32)
            want = terms[label]
            f32_models_hold(f'f32 {label} dense', vega.chi2_batch(
                want['points']).cpu().numpy(), want['f32']['chi2'],
                want['chi2_dense_f64'])
            if label == 'uv_fht_extrap':
                variant_grids['fht_extrap'] = \
                    vega.models['lyaxlya'].PktoXi.knot_grid
            log(f'f32 {label}: {time.perf_counter() - t0:.2f} s')
            del vega
    launches['f32_variants'] = dict(LAUNCHES)
    f32_only('f32 variants', launches['f32_variants'])
    checks += check_launches(device, 'f32_variants', layouts)
    single = sum(r.launches for key, r in layouts.items()
                 if key[0] == 'F' and key[3] == 1)
    if not single:
        fail('the f32 single_multipole variant launched no F_0 of one '
             'table')

    # --- table6's 4-dimension sweep in f32, cold: counts from zero
    t0 = time.perf_counter()
    table6 = json.loads(TABLE6_GOLDENS.read_text())
    main_ini = f32_terms_files(device, work, 'table6')[0]
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None), \
            switch('VEGA_TPU_GRID_CACHE', '0'):
        vega = VegaInterface(main_ini, device=device, dtype=torch.float32)
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            t1 = time.perf_counter()
            payload = vega.get_collapsed(frozenset(table6['names']))
            torch.cuda.synchronize(device)
            cold_s = time.perf_counter() - t1
            got = vega.chi2_batch(table6['params']).cpu().numpy()
        launches['f32_table6_sweep'] = dict(LAUNCHES)
        f32_only('f32 table6 sweep', launches['f32_table6_sweep'])
        checks += check_launches(device, 'f32_table6_sweep', layouts)
    spec = payload['__grid__']
    components = plan_components(spec)
    log(f'f32 table6 cold sweep: {spec}; {len(components)} components, '
        f'{sum(int(np.prod(d)) for d, _ in components)} swept nodes, '
        f'device sweep {vega.grid_stats["sweep_s"]:.3f} s, host payload '
        f'build {vega.grid_stats["host_s"]:.3f} s, total {cold_s:.3f} s; '
        f'kernel launches {launches["f32_table6_sweep"]}')
    if spec.degrees != (32, 32, 12, 12) or sorted(payload) != [
            '__grid__', 'lyaxlya', 'qsoxlya']:
        fail(f'f32 table6: the grid is {spec}, serving {sorted(payload)}')
    if not np.all(np.isfinite(got)):
        fail('f32 table6 route chi2 is not finite')
    check_f32_route('table6', got, F64_ROUTE_CHI2.get('table6'),
                    table6['chi2_dense'])
    del vega
    log(f'f32 table6: {time.perf_counter() - t0:.1f} s')

    # --- edge layouts in f32 on the uv path's two knot grids
    if legacy_grid.dtype != torch.float32:
        fail('the f32 uv interface built its legacy knot grid in '
             f'{legacy_grid.dtype}')
    edges += check_edge_layouts(device, legacy_grid, 2,
                                'legacy, relativistic pair')
    edges += check_edge_layouts(device, variant_grids['fht_extrap'], 4,
                                'fht_extrap')
    log(f'f32_terms phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks, edges


# ----------------------------------------------------------------------
# The f32 mode's likelihood options (phase f32_options)
# ----------------------------------------------------------------------
F32_OPTIONS_GOLDENS = (ROOT / 'tests' / 'data'
                       / 'torch_port_f32_options_goldens.json')
# an f32 model array (a saved component, the multipoles, the Monte-Carlo
# fiducial) against vega_tpu's, of max|f64|; the template coefficients,
# of their largest f64 entry (vega_tpu's own f32 at full size: 4.2e-6 and
# 5.4e-6, tests/data/torch_port_f32_options_goldens.json)
F32_ARRAY_RTOL = 1e-5
F32_COEFF_RTOL = 1e-4


def f32_option_files(device, work):
    """The inis phase f32_options reads: phase marg's synthetic-desi-marg-
    full (main.ini, main_in_fit.ini), option_inis on phase mc's files and
    phase dr16pub's files with the components written (into
    work/f32_options/components, only inis; the one file set this phase
    writes). Fails if phase marg, mc or dr16pub has not written its
    files."""
    from vega_tpu_torch.testing import make_dr16_published_dataset
    work = Path(work)
    inis = {'marg': work / 'marg' / 'main.ini',
            'marg_in_fit': work / 'marg' / 'main_in_fit.ini'}
    for ini in (inis['marg_in_fit'], work / 'mc' / 'main.ini',
                work / 'dr16pub' / 'main.ini'):
        if not ini.exists():
            fail(f'f32_options reads {ini}: run its phase first')
    inis.update(option_inis(work))
    inis['components'] = Path(make_dr16_published_dataset(
        work / 'f32_options' / 'components', size='full', device=device,
        components=True, files_from=work / 'dr16pub'))
    return inis


def f32_coefficients(label, got, want64, want32=None):
    """Template coefficients ({name: array}) against vega_tpu's f64 (and
    its f32 record {name: {'dtype', 'values'}}: the same dtype, values
    within F32_COEFF_RTOL too)."""
    if sorted(got) != sorted(want64):
        fail(f'{label}: coefficients of {sorted(got)}, vega_tpu '
             f'{sorted(want64)}')
    worst = max(rel_err(got[n], w) for n, w in want64.items())
    dtypes = {n: str(np.asarray(v).dtype) for n, v in got.items()}
    line = (f'{label}: {dtypes}, max relative diff {worst:.3e} from '
            'vega_tpu\'s f64')
    if want32 is not None:
        worst32 = max(rel_err(got[n], w['values'])
                      for n, w in want32.items())
        line += f', {worst32:.3e} from its f32'
        worst = max(worst, worst32)
        if dtypes != {n: w['dtype'] for n, w in want32.items()}:
            fail(f'{label}: dtypes {dtypes}, vega_tpu\'s f32 '
                 f'{ {n: w["dtype"] for n, w in want32.items()} }')
    log(line + f' (bound {F32_COEFF_RTOL:g})')
    if not worst <= F32_COEFF_RTOL:
        fail(f'{label}: coefficients differ by {worst:.3e}')


def f32_summaries(label, got, want64, want32):
    """Arrays ({key: array}) against vega_tpu's summaries ({key: {size,
    max_abs, index, values}}) of its f64 and f32: the keys, float32 as
    vega_tpu's f32 keeps them, the values at the summaries' indices
    within F32_ARRAY_RTOL of max|f64|."""
    if sorted(got) != sorted(want64) or sorted(got) != sorted(want32):
        fail(f'{label}: keys {sorted(got)}, vega_tpu {sorted(want64)}')
    worst = 0.
    for key, value in got.items():
        value = np.asarray(value)
        w64, w32 = want64[key], want32[key]
        if str(value.dtype) != w32['dtype'] or value.size != w64['size']:
            fail(f'{label} {key}: {value.dtype} of {value.size}, vega_tpu '
                 f'{w32["dtype"]} of {w64["size"]}')
        picked = value.ravel()[w64['index']]
        worst = max(worst, *(float(np.max(np.abs(picked - w['values'])))
                             / w64['max_abs'] for w in (w64, w32)))
    log(f'{label}: {len(got)} arrays, float32, max diff {worst:.3e} of '
        f'max|f64| from vega_tpu\'s f64 and f32 (bound {F32_ARRAY_RTOL:g})')
    if not worst <= F32_ARRAY_RTOL:
        fail(f'{label}: differ from vega_tpu by {worst:.3e} of max|f64|')


def run_f32_options_path(device, work, card):
    """Phase f32_options (see the module docstring); returns the kernel
    launches of its paths and the kernel checks at their layouts."""
    import vega_tpu_torch.metals as metals_mod
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import VegaInterface

    full = json.loads(F32_OPTIONS_GOLDENS.read_text())['full']
    marg = json.loads(MARG_GOLDENS.read_text())
    names = marg['names']
    cov, in_fit = marg['cov'], marg['in_fit']
    t_phase = time.perf_counter()
    inis = f32_option_files(device, work)
    log(f'f32_options: files in {time.perf_counter() - t_phase:.2f} s')
    launches, checks = {}, []

    # --- (a) the templates in the covariance, dense: counts from zero
    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        dense = VegaInterface(inis['marg'], device=device,
                              dtype=torch.float32)
    modes = dict(dense.corr_num_marg_modes)
    log(f'f32 marg dense: interface in {time.perf_counter() - t0:.2f} s, '
        f'retained modes {modes} (JAX {cov["modes"]})')
    if modes != cov['modes'] or dense.dtype != torch.float32:
        fail('f32 marg: the modes or the dtype differ')
    models = list(dense.models.values())
    f32_terms_dense(device, 'marg', dense, names, cov['params'],
                    full['marg']['f32']['chi2'], cov['chi2_dense'], launches,
                    checks, hooks={
                        'metal matrices': [(m.metals, 'apply_metal_matrix')
                                           for m in models],
                        'metal combine': [(metals_mod,
                                           'spline_legendre_combine')],
                        'power-spectrum grids': [
                            (m.Pk_core, 'compute_peak_smooth')
                            for m in models]},
                    watch=[(m.metals, 'compute') for m in models])
    best = dict(zip(names, cov['fit_dense']['values']))
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        f32_coefficients('f32 marg best-fit coefficients (compute_marg_coeff '
                         'at the JAX best fit)',
                         dense.compute_marg_coeff(dense.compute_model(
                             best, run_init=False)),
                         cov['fit_dense']['bestfit_marg_coeff'])
    launches['f32_marg_coeff'] = dict(LAUNCHES)
    f32_only('f32 marg coefficients', launches['f32_marg_coeff'])
    checks += check_launches(device, 'f32_marg_coeff', layouts)
    del dense

    # --- (b) vega_tpu's grid route on the updated covariance, cold:
    # counts from zero
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None), \
            switch('VEGA_TPU_GRID_CACHE', '0'):
        grid = VegaInterface(inis['marg'], device=device,
                             dtype=torch.float32)
        LAUNCHES.clear()
        with recorded_launches() as layouts:
            t0 = time.perf_counter()
            payload = grid.get_collapsed(frozenset(names))
            torch.cuda.synchronize(device)
            cold_s = time.perf_counter() - t0
            got = grid.chi2_batch(cov['params']).cpu().numpy()
    launches['f32_marg_grid'] = dict(LAUNCHES)
    f32_only('f32 marg grid', launches['f32_marg_grid'])
    checks += check_launches(device, 'f32_marg_grid', layouts)
    log(f'f32 marg grid cold build: {payload.get("__grid__")}, serves '
        f'{sorted(set(payload) - {"__grid__"})}, {cold_s:.3f} s; kernel '
        f'launches {launches["f32_marg_grid"]}')
    if sorted(payload) != ['__grid__', 'lyaxlya', 'qsoxlya'] \
            or not np.all(np.isfinite(got)):
        fail('f32 marg grid: the payload does not serve both correlations, '
             'or its chi2 is not finite')
    f32_ladder('f32 marg grid vs vega_tpu\'s f64 grid', got,
               cov['chi2_grid'])
    del grid

    # --- (c) marginalize-in-fit: every call dense; counts from zero
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        t0 = time.perf_counter()
        fit_vega = VegaInterface(inis['marg_in_fit'], device=device,
                                 dtype=torch.float32)
    log(f'f32 marg in-fit: interface in {time.perf_counter() - t0:.2f} s')
    if fit_vega.get_collapsed(frozenset(names)) != {}:
        fail('f32 marg in-fit: a collapse serves marginalize-in-fit')
    want = full['marg_in_fit']
    best = dict(zip(names, in_fit['fit_dense']['values']))
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        chi2 = fit_vega.chi2_batch(in_fit['params']).cpu().numpy()
        f32_models_hold('f32 marg in-fit dense', chi2, want['f32']['chi2'],
                        in_fit['chi2_dense'])
        value, grad = fit_vega.chi2_value_and_gradient(
            in_fit['derivative_points'][0])
        g = [grad[n] for n in names]
        for label, want_value, want_grad in (
                ('f64', in_fit['dense']['chi2'][0],
                 in_fit['dense']['gradient'][0]),
                ('f32', want['f32']['value/derivative_0'],
                 [want['f32']['gradient/derivative_0'][n] for n in names])):
            f32_ladder(f'f32 marg in-fit value at the first derivative '
                       f'point vs vega_tpu\'s {label}', [value], [want_value])
            bound = max(F32_CHI2_ABS,
                        F32_CHI2_REL * float(np.max(np.abs(want_grad))))
            worst = float(np.max(np.abs(np.asarray(g) - want_grad)))
            log(f'f32 marg in-fit gradient there vs vega_tpu\'s {label}: '
                f'max |d| {worst:.4g} (gate {bound:.4g})')
            if not worst <= bound:
                fail('f32 marg in-fit gradient outside the ladder')
        check_golden_minimum('f32 marg in-fit', device, fit_vega, names,
                             in_fit['fit_dense'], 'f32')
        value, grad = fit_vega.chi2_value_and_gradient(best)
        f32_ladder('f32 marg in-fit value at the JAX best fit vs vega_tpu\'s '
                   'f64', [value], [want['f64']['value/bestfit']])
        f32_ladder('f32 marg in-fit value at the JAX best fit vs vega_tpu\'s '
                   'f32', [value], [want['f32']['value/bestfit']])
        log('f32 marg in-fit gradient at the JAX best fit: port '
            + ', '.join(f'{n} {grad[n]:.4g}' for n in names)
            + '; vega_tpu f32 ' + ', '.join(
                f'{n} {want["f32"]["gradient/bestfit"][n]:.4g}'
                for n in names)
            + '; vega_tpu f64 ' + ', '.join(
                f'{n} {want["f64"]["gradient/bestfit"][n]:.3g}'
                for n in names)
            + ' (held by the Newton step above: f32 round-off of a '
            'gradient that vanishes there)')
        _, coeffs = fit_vega.chi2(best, return_marg_coeff=True)
        f32_coefficients('f32 marg in-fit coefficients the chi^2 fitted at '
                         'the JAX best fit', coeffs,
                         in_fit['fit_dense']['bestfit_marg_coeff'],
                         want['f32']['coeff'])
        f32_coefficients('f32 marg in-fit compute_marg_coeff at the JAX best '
                         'fit', fit_vega.compute_marg_coeff(
                             fit_vega.compute_model(best, run_init=False)),
                         in_fit['fit_dense']['bestfit_marg_coeff'],
                         want['f32']['compute_marg_coeff'])
        torch.cuda.synchronize(device)
        in_fit_s = time.perf_counter() - t0
    launches['f32_marg_in_fit'] = dict(LAUNCHES)
    f32_only('f32 marg in-fit', launches['f32_marg_in_fit'])
    checks += check_launches(device, 'f32_marg_in_fit', layouts)
    log(f'f32 marg in-fit: {in_fit_s:.2f} s, kernel launches '
        f'{launches["f32_marg_in_fit"]}')
    del fit_vega

    # --- (d) save-components on phase dr16pub's files, dense: counts from
    # zero
    rv = json.loads(RUN_VEGA_GOLDENS.read_text())
    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        vega = VegaInterface(inis['components'], device=device,
                             dtype=torch.float32)
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        model = vega.compute_model(rv['point'], run_init=False)
        torch.cuda.synchronize(device)
    launches['f32_components'] = dict(LAUNCHES)
    f32_only('f32 components', launches['f32_components'])
    checks += check_launches(device, 'f32_components', layouts)
    single = sum(r.launches for key, r in layouts.items()
                 if key[0] == 'F' and key[1] == 0 and key[2] == 1)
    log(f'f32 components: interface and compute_model at the run_vega '
        f'goldens\' point in {time.perf_counter() - t0:.2f} s, kernel '
        f'launches {launches["f32_components"]}, {single} of them F_0 at '
        'B = 1')
    if not single:
        fail('f32 components: no F_0 at B = 1 (the unrolled metal pairs)')
    for corr, m in vega.models.items():
        saved = component_summaries(m)
        f32_summaries(f'f32 components {corr}', {**saved, 'model':
                                                 model[corr]},
                      rv['components'][corr],
                      {**full['components']['f32']['components'][corr],
                       'model': full['components']['f32']['model'][corr]})
    vega.output.outfile = str(Path(work) / 'f32_options' / 'components'
                              / 'f32_results')
    vega.output.write_results(model, vega.params, models=vega.models)
    path = vega.output.outfile + '.fits'
    hdus = {h.name: h for h in read_fits(path) if getattr(h, 'name', '')}
    for corr, m in vega.models.items():
        for hdu, columns in (
                (f'PK_{corr}', vega.output._get_components(m.pk)),
                (f'Xi_{corr}', vega.output._cf_hdu(corr, m)['columns'])):
            for column, value in columns.items():
                read = np.asarray(hdus[hdu][column])
                if read.dtype != np.float32 or \
                        not np.array_equal(read, value):
                    fail(f'f32 components: {hdu} {column} is not the '
                         'float32 in-memory component')
    log(f'f32 components: {path} ({os.path.getsize(path) / 1e6:.1f} MB) '
        f'holds {len(hdus)} HDUs; every PK_ / Xi_ column float32 and equal '
        'to the in-memory component')
    del vega

    # --- (e) model_pk and use_full_pk_for_mc on phase mc's files: counts
    # from zero
    options = json.loads(OPTIONS_GOLDENS.read_text())
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        t0 = time.perf_counter()
        vega = VegaInterface(inis['model_pk'], device=device,
                             dtype=torch.float32)
        multipoles = vega.compute_model(run_init=False)
        f32_summaries('f32 model_pk multipoles', multipoles, {
            n: f32_full_summary(v) for n, v in options['model_pk'].items()},
            {n: f32_full_summary(v['values'], v['dtype']) for n, v in
             full['model_pk']['f32']['multipoles'].items()})
        del vega
        vega = VegaInterface(inis['direct'], device=device,
                             dtype=torch.float32)
        fiducial = vega.get_fiducial_for_monte_carlo(print_func=log)
        f32_summaries('f32 use_full_pk_for_mc fiducial', fiducial, {
            n: f32_full_summary(v)
            for n, v in options['direct']['fiducial'].items()},
            {n: f32_full_summary(v['values'], v['dtype']) for n, v in
             full['direct']['f32']['fiducial'].items()})
        del vega
        options_s = time.perf_counter() - t0
    launches['f32_options_model'] = dict(LAUNCHES)
    f32_only('f32 model_pk and use_full_pk_for_mc',
             launches['f32_options_model'])
    checks += check_launches(device, 'f32_options_model', layouts)
    log(f'f32 model_pk and use_full_pk_for_mc: {options_s:.2f} s '
        f'(interfaces included), kernel launches '
        f'{launches["f32_options_model"]}')

    # --- (f) correlations without a data file
    vega = VegaInterface(inis['data_free'], device=device,
                         dtype=torch.float32)
    got = {
        'compute_model': raised(
            lambda: vega.compute_model({'bias_LYA': -0.11})),
        'compute_model_no_init': raised(lambda: vega.compute_model(
            {'bias_LYA': -0.11}, run_init=False)),
        'chi2': raised(lambda: vega.chi2({'bias_LYA': -0.11})),
        'chi2_batch': raised(lambda: vega.chi2_batch(
            {'bias_LYA': np.array([-0.11, -0.12])}))}
    want = full['data_free']['f32']['raises']
    log(f'f32 data-free: raises {got} (vega_tpu\'s f32 {want})')
    if got != want:
        fail('f32 data-free: the evaluations do not raise as vega_tpu\'s')
    log(f'f32_options phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, checks


def f32_full_summary(values, dtype='float64'):
    """A whole array as a summary of every index (f32_summaries' form)."""
    x = np.asarray(values, dtype=float).ravel()
    return {'size': int(x.size), 'max_abs': float(np.max(np.abs(x))),
            'index': list(range(x.size)), 'values': x, 'dtype': dtype}


# ----------------------------------------------------------------------
# Several devices (phase devices) and the examples (phase examples)
# ----------------------------------------------------------------------
SHARD_RTOL = 1e-12      # sharded against unsharded chi^2, of |chi^2|
SHARD_ROWS = (BATCH, BATCH - 1)
SHARD_ROUNDS = 3
DEVICES_MOCKS = 32
DEVICES_MC_SCRIPT_MOCKS = 16
TWO_PROCESS_TIMEOUT_S = 300
EXAMPLE_TIMEOUT_S = 600
EXAMPLE_WORKERS = 3
# each example counterpart on the card at its own settings, and the line
# its run must print (tests/test_torch_examples*.py hold their numbers
# against vega_tpu's on the CPU)
EXAMPLES = (
    ('examples/eBOSS_DR16/run_synthetic_torch.py',
     'All four fits recover the injected truth.'),
    ('examples/tutorials_torch/06_samplers_and_batching.py',
     'MC campaign:'),
    ('examples/tutorials_torch/01_getting_started.py', '(valid=True)'),
    ('examples/tutorials_torch/02_model_components.py',
     'peak+smooth == full: True'),
    ('examples/tutorials_torch/03_plots.py', 'wedge mu in (0.5, 1)'),
    ('examples/tutorials_torch/04_fit_results_and_output.py',
     'results file:'),
    ('examples/tutorials_torch/05_sensitivity_and_scans.py',
     'profile minimum at bias = -0.1170'),
    ('examples/tutorials_torch/07_config_creation.py',
     'chi2 on the generated setup:'),
    ('examples/Monte_carlo_sims/run_mc_demo_torch.py', 'MC demo OK'),
    ('examples/synthetic_tutorial_torch.py', 'wrote'),
)


def timed_turns(calls, rounds):
    """{label: [s per round]}: each call synchronised, the calls in turns
    round after round (one call's warm-up before the rounds)."""
    times = {label: [] for label in calls}
    for fn in calls.values():
        fn()
    for _ in range(rounds):
        for label, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    return times


def sharded_chi2(label, device, vega, meshes, launches, layouts_out):
    """BatchedLikelihood over each mesh at SHARD_ROWS rows against the
    unsharded chi2_batch (SHARD_RTOL of |chi^2|); the launches of the
    sharded calls alone (counts from zero), then the sharded and
    unsharded calls timed in turns."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import BatchedLikelihood
    mesh2 = meshes['two']
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        got = {n: BatchedLikelihood(vega, mesh=mesh2).chi2(draw_batch(n))
               for n in SHARD_ROWS}
        torch.cuda.synchronize(device)
    launches[f'devices_{label}'] = dict(LAUNCHES)
    layouts_out.update(layouts)
    for n_rows, chi2 in got.items():
        want = vega.chi2_batch(draw_batch(n_rows))
        err = float(torch.max(torch.abs(chi2 - want) / torch.abs(want)))
        log(f'devices {label}: BatchedLikelihood over {mesh2} at {n_rows} '
            f'rows against the unsharded chi2_batch: max |d chi2| / |chi2| '
            f'{err:.3e} (bound {SHARD_RTOL:g}); finite '
            f'{bool(torch.isfinite(chi2).all())}')
        if chi2.shape != (n_rows,) or not err <= SHARD_RTOL or \
                not bool(torch.isfinite(chi2).all()):
            fail(f'devices {label}: the sharded chi^2 at {n_rows} rows '
                 f'differs from the unsharded one by {err:.3e}')
    batch = draw_batch(BATCH)
    times = timed_turns({
        'unsharded': lambda: vega.chi2_batch(batch),
        'mesh of 1': lambda: BatchedLikelihood(
            vega, mesh=meshes['one']).chi2(batch),
        'mesh of cuda:0 twice': lambda: BatchedLikelihood(
            vega, mesh=mesh2).chi2(batch)}, SHARD_ROUNDS)
    base = float(np.median(times['unsharded']))
    log(f'devices {label}: {BATCH} rows, s per call (median of '
        f'{SHARD_ROUNDS}, in turns): ' + ', '.join(
            f'{k} {float(np.median(v)):.4f} (x{float(np.median(v)) / base:.3f};'
            f' rounds {", ".join(f"{t:.4f}" for t in v)})'
            for k, v in times.items()) + f'; kernel launches '
        f'{launches[f"devices_{label}"]}')
    return times


def devices_worker(rank, address, main_ini, out, device, n_rows):
    """One process of the two-process run (phase devices): joins a gloo
    group of two, builds the interface on `device` (the grid payload,
    swept in this process) and writes the chi^2 of draw_batch(n_rows) over
    global_mesh() (each process's `device`), with its kernel launches, to
    `out` (npz)."""
    from vega_tpu_torch.ops.spline_combine import LAUNCHES
    from vega_tpu_torch.parallel import (BatchedLikelihood, global_mesh,
                                         initialize, local_batch_slice)
    from vega_tpu_torch.parallel.distributed import process_count
    from vega_tpu_torch.vega_interface import VegaInterface
    initialize(address, num_processes=2, process_id=rank)
    mesh = global_mesh(devices=[device])
    vega = VegaInterface(main_ini, device=device)
    LAUNCHES.clear()
    vega.chi2_batch(draw_batch(8))          # the payload, swept here
    chi2 = BatchedLikelihood(vega, mesh=mesh).chi2(draw_batch(n_rows))
    np.savez(out, chi2=chi2.cpu().numpy(), count=process_count(),
             slice=np.asarray(local_batch_slice(n_rows)),
             mesh=np.asarray([str(d) for d in mesh.devices]),
             ranks=np.asarray(mesh.ranks),
             launches=json.dumps({f'{k[0]}_{k[1]}': v
                                  for k, v in LAUNCHES.items()}))


def two_process_run(device, work, main_ini, grid_vega, launches):
    """Two processes (subprocesses, gloo, both on cuda:0), each on the
    grid path with the payload it swept itself (a dense chunk of 1,024
    rows takes tens of GB in each process): each holds every gathered
    chi^2, equal to this process's unsharded chi2_batch (SHARD_RTOL).
    Their F_0 launches (the sweeps) are recorded under the path
    devices_two_processes."""
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        address = f'localhost:{sock.getsockname()[1]}'
    env = {k: v for k, v in os.environ.items()
           if k not in ('VEGA_TPU_FACTORED', 'VEGA_TPU_GRID_COLLAPSE')}
    env['VEGA_TPU_GRID_CACHE'] = '0'     # each process sweeps its own
    outs = [Path(work) / f'devices_rank{rank}.npz' for rank in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, '-c',
         'import chip_smoke as cs; cs.devices_worker('
         f'{rank}, {address!r}, {str(main_ini)!r}, {str(outs[rank])!r}, '
         f'{str(device)!r}, {BATCH})'],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TWO_PROCESS_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    seconds = time.perf_counter() - t0
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            fail(f'devices: process {rank} of the two-process run exited '
                 f'{proc.returncode}:\n{text[-3000:]}')
    want = grid_vega.chi2_batch(draw_batch(BATCH)).cpu().numpy()
    counts = {}
    for rank, out in enumerate(outs):
        got = np.load(out)
        err = float(np.max(np.abs(got['chi2'] - want) / np.abs(want)))
        log(f'devices two processes: rank {rank} of {int(got["count"])}, '
            f'its slice {got["slice"].tolist()}, mesh '
            f'{got["mesh"].tolist()} of ranks {got["ranks"].tolist()}, '
            f'{got["chi2"].size} gathered chi^2 against the unsharded '
            f'chi2_batch: max |d chi2| / |chi2| {err:.3e} (bound '
            f'{SHARD_RTOL:g}); its launches {str(got["launches"])}')
        if got['chi2'].shape != want.shape or not err <= SHARD_RTOL \
                or int(got['count']) != 2:
            fail(f'devices: process {rank} holds chi^2 {err:.3e} from the '
                 'unsharded values')
        for key, n in json.loads(str(got['launches'])).items():
            primitive, order = key.split('_')
            counts[(primitive, int(order))] = counts.get(
                (primitive, int(order)), 0) + n
    launches['devices_two_processes'] = counts
    log(f'devices two processes: {seconds:.1f} s for both (start, '
        f'interface, sharded call); kernel launches {counts}')


def run_devices_path(device, work, main_ini, fit_ini, card):
    """Phase devices (several devices in one process, and two
    processes), on the synthetic full configuration, with phase examples
    started in the background once its timed calls are done (the
    examples' processes share the card and the host with the rest of
    it); returns the kernel launches of its paths, the kernel checks at
    their layouts, the timings of the sharded calls and the started
    examples (`finish_examples`)."""
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.parallel import (MonteCarloEngine,
                                         ShardedGlobalChi2,
                                         batched_chi2_scan,
                                         make_device_mesh)
    from vega_tpu_torch.scripts import run_vega_mc
    from vega_tpu_torch.vega_interface import VegaInterface, parse_ini

    every = make_device_mesh()
    n_cards = torch.cuda.device_count()
    log(f'devices: make_device_mesh() {every} ({n_cards} card(s) seen); '
        f'make_device_mesh(2) {make_device_mesh(2)}')
    if every.size != n_cards or make_device_mesh(2).size != min(2, n_cards):
        fail('devices: make_device_mesh does not span the cards as '
             'vega_tpu slices its devices')
    meshes = {'one': make_device_mesh(devices=[device]),
              'two': make_device_mesh(devices=[device, device])}
    launches, layouts = {}, {}

    # --- BatchedLikelihood, dense and on the grid payload
    with switch('VEGA_TPU_FACTORED', '0'):
        dense = VegaInterface(main_ini, device=device)
    timings = {'dense': sharded_chi2('dense', device, dense, meshes,
                                     launches, layouts)}
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid = VegaInterface(main_ini, device=device)
        grid.chi2_batch(draw_batch(8))        # the payload, built once
    timings['grid'] = sharded_chi2('grid', device, grid, meshes, launches,
                                   layouts)
    del dense
    # the cache of this process's earlier phases (up to ~79 GB) back to
    # the card for the processes started from here on
    torch.cuda.empty_cache()

    # --- two processes (gloo), both on cuda:0
    two_process_run(device, work, main_ini, grid, launches)
    del grid
    examples = start_examples(device)

    # --- the sharded batched Newton: the scan's 16 golden points
    goldens = json.loads(MC_GOLDENS.read_text())
    lo, hi, n_axis = goldens['scan']['axis']
    axis = np.linspace(lo, hi, n_axis)
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        fit_vega = VegaInterface(fit_ini, device=device)
    points = sorted({min(range(n_axis), key=lambda i: abs(axis[i] - r['ap']))
                     for r in goldens['scan']['rows']})
    grids = {'ap': axis[points], 'at': axis[points]}
    scans = {}
    for label, mesh, chunk in (('one', meshes['one'], len(points) ** 2),
                               ('two', meshes['two'], len(points) ** 2 // 2)):
        stats = {}
        with switch('VEGA_TPU_FIT_CHUNK_PER_DEVICE', str(chunk)):
            t0 = time.perf_counter()
            scans[label] = batched_chi2_scan(fit_vega, grids, mesh=mesh,
                                             stats=stats)
            torch.cuda.synchronize(device)
        log(f'devices scan over the mesh of {mesh.size}: '
            f'{len(scans[label])} points, {chunk} per device, '
            f'{time.perf_counter() - t0:.3f} s, Newton iterations '
            f'{stats["iterations"]}, {stats["valid_rows"]} valid')
        if stats['valid_rows'] != len(scans[label]):
            fail('devices: a sharded scan row is not valid')
    d_fval = max(abs(a['fval'] - b['fval'])
                 for a, b in zip(scans['one'], scans['two']))
    d_sigma = d_golden = 0.0
    for want in goldens['scan']['rows']:
        got = next(r for r in scans['two']
                   if (r['ap'], r['at']) == (want['ap'], want['at']))
        d_golden = max(d_golden, abs(got['fval'] - want['fval'])
                       / (GRID_ABS_TOL + GRID_REL_TOL * abs(want['fval'])))
        for name in goldens['scan']['free']:
            d_sigma = max(d_sigma, abs(got[name] - want[name])
                          / want['errors'][name])
    log(f'devices scan: mesh of 2 vs mesh of 1 max |d fval| {d_fval:.3e} '
        f'(bound {SCAN_CHUNK_FVAL_ABS:g}); vs the JAX goldens max |d fval| '
        f'{d_golden:.3e} of its bound, values {d_sigma:.3e} errors (bound '
        f'{FIT_VALUE_SIGMA["grid"]:g})')
    if not (d_fval <= SCAN_CHUNK_FVAL_ABS and d_golden <= 1.0
            and d_sigma <= FIT_VALUE_SIGMA['grid']):
        fail('devices: the sharded scan misses the unsharded one or the '
             'JAX goldens')
    del fit_vega

    # --- the sharded mock fits: dense, the goldens' numpy mocks and
    # DEVICES_MOCKS drawn ones
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        mc_vega = VegaInterface(Path(work) / 'mc' / 'main.ini', device=device)
    fiducial = mc_vega.compute_model(mc_vega.mc_config['params'],
                                     run_init=False)
    want = goldens['mc']['dense']
    sample = {key: {n: mc_vega.mc_config['sample'][key][n]
                    for n in want['names']}
              for key in ('limits', 'values', 'errors', 'fix')}
    drawn = MonteCarloEngine(mc_vega, mesh=meshes['one']).generate_mocks(
        fiducial, DEVICES_MOCKS, seed=MC_SEED)
    fits = {}
    LAUNCHES.clear()
    with recorded_launches() as mc_layouts:
        fits['two'] = timed_mock_fits(
            device, MonteCarloEngine(mc_vega, mesh=meshes['two']), drawn,
            sample, DEVICES_MOCKS // 2, 'devices mc dense, mesh of 2')
        golden = timed_mock_fits(
            device, MonteCarloEngine(mc_vega, mesh=meshes['two']),
            numpy_mocks(mc_vega, fiducial, want['n_mocks'], want['seed']),
            sample, DEFAULT_FIT_CHUNK, 'devices mc dense golden, mesh of 2')
    launches['devices_mc'] = dict(LAUNCHES)
    layouts.update(mc_layouts)
    check_mock_fits('devices mc dense golden, mesh of 2', golden, want)
    fits['one'] = timed_mock_fits(
        device, MonteCarloEngine(mc_vega, mesh=meshes['one']), drawn,
        sample, DEVICES_MOCKS, 'devices mc dense, mesh of 1')
    check_mock_fits('devices mc dense, mesh of 2 vs mesh of 1', fits['two'],
                    {k: fits['one'][k].tolist()
                     for k in ('values', 'errors', 'chisq', 'valid')})
    del mc_vega
    torch.cuda.empty_cache()

    # --- ShardedGlobalChi2 at the size of the synthetic-desi joint
    # covariance (phase desi's file)
    cov = np.asarray([h for h in read_fits(Path(work) / 'desi' /
                                           'global_cov.fits')
                      if getattr(h, 'name', '') == 'COV'][0]['COV'],
                     dtype=np.float64)
    chol = torch.linalg.cholesky(torch.as_tensor(cov, device=device))
    invcov = torch.cholesky_inverse(chol)
    rng = np.random.default_rng(3)
    diffs = torch.as_tensor(rng.normal(size=(64, cov.shape[0])) * np.sqrt(
        np.diag(cov)), device=device)
    sharded = ShardedGlobalChi2(invcov.cpu().numpy(), mesh=meshes['two'])
    got = sharded.chi2_batch(diffs)
    one = torch.sum(diffs * (diffs @ invcov), dim=-1)
    err = float(torch.max(torch.abs(got.to(device) - one) / torch.abs(one)))
    err1 = abs(float(sharded.chi2(diffs[0])) - float(one[0])) / abs(
        float(one[0]))
    log(f'devices ShardedGlobalChi2: the synthetic-desi joint covariance '
        f'({cov.shape[0]} x {cov.shape[0]}), row blocks '
        f'{[tuple(b.shape) for _, b in sharded._blocks]} on '
        f'{meshes["two"]}; 64 diffs against the one-device f64 quadratic '
        f'form: max relative {err:.3e}, one diff {err1:.3e} (bound '
        f'{SHARD_RTOL:g})')
    if not (err <= SHARD_RTOL and err1 <= SHARD_RTOL):
        fail('devices: ShardedGlobalChi2 misses the one-device quadratic '
             'form')
    del cov, chol, invcov, sharded

    # --- run_vega_mc --n-devices 2 against --n-devices 1
    config = parse_ini(fit_ini)
    config['control'].update({'run_montecarlo': 'True',
                              'num_mc_mocks': str(DEVICES_MC_SCRIPT_MOCKS),
                              'mc_seed': '0'})
    config['monte carlo'] = {n: config['sample'][n]
                             for n in ('bias_LYA', 'beta_LYA')}
    config['mc parameters'] = {'bias_LYA': '-0.117', 'beta_LYA': '1.67'}
    tables = {}
    for n_devices in ('2', '1'):
        out = Path(work) / f'devices_mc_{n_devices}'
        out.mkdir()
        config['output']['filename'] = str(out / 'output')
        ini = out / 'main_mc.ini'
        with open(ini, 'w') as fh:
            config.write(fh)
        t0 = time.perf_counter()
        LAUNCHES.clear()
        if run_vega_mc.main([str(ini), '--n-devices', n_devices]) != 0:
            fail(f'run_vega_mc --n-devices {n_devices} exited non-zero')
        launches[f'devices_mc_script_{n_devices}'] = dict(LAUNCHES)
        tables[n_devices] = {h.name: h for h in read_fits(
            out / 'monte_carlo' / 'monte_carlo.fits')
            if getattr(h, 'name', '')}['Bestfit']
        log(f'devices: run_vega_mc --n-devices {n_devices} '
            f'({DEVICES_MC_SCRIPT_MOCKS} mocks; the mesh '
            f'{run_vega_mc.device_mesh("cuda", int(n_devices))}) '
            f'{time.perf_counter() - t0:.2f} s')
    worst = max(float(np.max(np.abs(np.asarray(tables['2'][col])
                                    - np.asarray(tables['1'][col]))
                             / np.abs(np.asarray(tables['1'][col]))))
                for col in ('values', 'errors'))
    log(f'devices: run_vega_mc --n-devices 2 vs 1: Bestfit values and '
        f'errors agree to {worst:.3e} relative (bound {MC_TABLE_RTOL:g})')
    if not worst <= MC_TABLE_RTOL:
        fail('devices: run_vega_mc --n-devices 2 differs from 1')
    return (launches, check_launches(device, 'devices', layouts), timings,
            examples)


def start_examples(device):
    """Phase examples, started: each counterpart of EXAMPLES in a process
    of its own on the card at its own settings, EXAMPLE_WORKERS at a time
    (the longest first), in the background; `finish_examples` waits for
    them."""
    from concurrent.futures import ThreadPoolExecutor
    out_dir = ROOT / 'build' / 'examples'     # each script's output
    out_dir.mkdir(parents=True, exist_ok=True)

    def run(example):
        script, expect = example
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / script), '--device', str(device)],
            cwd=str(ROOT), capture_output=True, text=True,
            timeout=EXAMPLE_TIMEOUT_S,
            env=dict(os.environ, OMP_NUM_THREADS='2'))
        seconds = time.perf_counter() - t0
        (out_dir / f'example_{Path(script).stem}.log').write_text(
            proc.stdout + proc.stderr)
        return script, expect, proc, seconds

    pool = ThreadPoolExecutor(EXAMPLE_WORKERS)
    return pool, [pool.submit(run, example) for example in EXAMPLES], \
        time.perf_counter()


def finish_examples(started):
    """Wait for the examples' processes: each must exit 0 and print its
    line."""
    pool, futures, t0 = started
    results = [future.result() for future in futures]
    pool.shutdown()
    for script, expect, proc, seconds in results:
        lines = [ln for ln in proc.stdout.splitlines() if expect in ln]
        log(f'examples: {script} exit {proc.returncode} in {seconds:.1f} s; '
            + (f'printed "{lines[-1].strip()}"' if lines else
               f'did not print "{expect}"'))
        if proc.returncode != 0 or not lines:
            fail(f'examples: {script} failed:\n'
                 f'{(proc.stdout + proc.stderr)[-3000:]}')
    log(f'examples: {len(EXAMPLES)} scripts in '
        f'{time.perf_counter() - t0:.1f} s, {EXAMPLE_WORKERS} at a time')


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
        f32_launches, f32_checks, f32_interfaces = run_f32_path(
            device, fit_ini, card)
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
        f32c_launches, f32c_replays, f32c_checks = run_f32_campaigns_path(
            device, work, fit_ini, f32_interfaces)
        del f32_interfaces
        mark('f32_campaigns')
        dr16_launches, dr16_checks = run_dr16_path(device, work, card)
        mark('dr16')
        uv_launches, uv_checks, uv_edges = run_uv_path(device, work, card)
        edge_checks += uv_edges
        mark('uv')
        desi_launches, desi_checks = run_desi_path(device, work, card)
        mark('desi')
        marg_launches, marg_checks = run_marg_path(device, work, card)
        mark('marg')
        options_launches, options_checks = run_options_path(device, work,
                                                            card)
        mark('options')
        table6_launches, table6_checks = run_table6_path(device, work, card,
                                                         fit_ini)
        mark('table6')
        dr16pub_launches, dr16pub_checks = run_dr16pub_path(device, work,
                                                            card)
        mark('dr16pub')
        f32_models_launches, f32_models_checks = run_f32_models_path(
            device, work, card)
        edge_checks += check_edge_layouts(
            device, KnotGrid.build(legacy_knot_grid(device, main_ini).values,
                                   device, torch.float32),
            n_ell, 'old_fftlog')
        mark('f32_models')
        desi_mock_launches, desi_mock_checks = run_desi_mock_path(
            device, work, card)
        mark('desi_mock')
        lyacolore_launches, lyacolore_checks = run_lyacolore_path(
            device, work, card)
        mark('lyacolore')
        f32t_launches, f32t_checks, f32t_edges = run_f32_terms_path(
            device, work, card)
        edge_checks += f32t_edges
        mark('f32_terms')
        f32o_launches, f32o_checks = run_f32_options_path(device, work,
                                                          card)
        mark('f32_options')
        devices_launches, devices_checks, _, examples = run_devices_path(
            device, work, main_ini, fit_ini, card)
        mark('devices')
        finish_examples(examples)
        mark('examples (after devices, started within it)')
        run_vega_launches, run_vega_checks = run_run_vega_path(
            device, work, card)
        mark('run_vega')
    log(f'all phases: {time.perf_counter() - t_start:.1f} s')

    checks = (dense_checks + grid_checks + fit_checks + f32_checks
              + scan_checks
              + mc_checks + sampler_checks + f32c_checks + dr16_checks
              + uv_checks
              + desi_checks + marg_checks + options_checks
              + table6_checks + dr16pub_checks + f32_models_checks
              + desi_mock_checks
              + lyacolore_checks + f32t_checks + f32o_checks
              + devices_checks + run_vega_checks)
    kernels = kernel_records(
        {'dense': dense_launches, 'grid': grid_launches, **fit_launches,
         **f32_launches,
         'scan': scan_launches, **mc_launches, **sampler_launches,
         **f32c_launches, **dr16_launches, **uv_launches, **desi_launches,
         **marg_launches, **options_launches, **table6_launches,
         **dr16pub_launches, **f32_models_launches, **desi_mock_launches,
         **lyacolore_launches, **f32t_launches, **f32o_launches,
         **devices_launches, **run_vega_launches},
        {**sampler_replays, **f32c_replays}, checks, edge_checks)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
