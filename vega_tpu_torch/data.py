"""Correlation-function data: data vector, scale-cut masks, covariance,
masked inverse covariance, log-determinant and distortion matrix.

Counterpart of vega_tpu/data.py, with the metal grids and matrices of the
legacy metal-file mode (`_init_metals`), the metal pairs of the
new-metals mode (whose matrices metals.py computes), the cosmology of
the file's header and the small-scale marginalization templates
(`_init_marginalization`: the distorted templates, the covariance update
and the matrix that turns a residual into template coefficients), and the
data-level blinding of the file's BLINDING header (`_load_data_vector`:
desi_dr3 reads the blinded DA_BLIND column and sets `blind`).
Host-side numpy throughout; the likelihood
copies what it needs to the device. Monte-Carlo mocks
(`create_monte_carlo`) draw from the numpy global RNG, as vega_tpu's do,
so a seeded host mock is the same numbers in both packages.
"""

from __future__ import annotations

import numpy as np

from . import mocks
from .coordinates import Coordinates
from .io.fits import read_fits
from .utils import compute_log_cov_det, compute_masked_invcov, find_file

# data-level blinding strategies: the data vector is the file's DA_BLIND
# (vega_tpu/data.py:20)
BLINDING_STRATEGIES = ['desi_dr3']


class Data:
    """Data for one correlation component (reference: data.py:12-134).

    With small-scale marginalization configured, `marg_templates` holds
    the distorted templates, `marg_diff2coeff_matrix` the coefficient
    matrix and `num_marg_modes` the modes kept by the SVD; the covariance
    takes `cov_marg_update` on its data-mask block unless
    `marginalize_in_fit` (the templates are then fitted per evaluation
    instead), and `effective_data_size` is the masked size less the
    modes."""

    def __init__(self, corr_item, marginalize_in_fit=False):
        self.corr_item = corr_item
        self.tracer1 = corr_item.tracer1
        self.tracer2 = corr_item.tracer2
        config = corr_item.config
        self.use_metal_autos = config['model'].getboolean(
            'use_metal_autos', True)
        self.cholesky_masked_cov = config['data'].getboolean(
            'cholesky-masked-cov', True)

        self.data_vec = None
        self.blind = None
        self.blinding_strat = None
        self._cov_mat = None
        self._distortion_mat = None
        self._inv_masked_cov = None
        self._log_cov_det = None

        self._read_data(config['data'].get('filename'), config['cuts'],
                        config['data'].get('distortion-file', None),
                        config['data'].get('covariance-file', None),
                        config['data'].getfloat('cov_rescale', None))
        corr_item.init_coordinates(self.model_coordinates,
                                   self.dist_model_coordinates,
                                   self.data_coordinates)
        self._wire_corr_item(corr_item)

        # absent matrices become exact identities (the model skips
        # identity matmuls entirely); with low_mem_mode under a global
        # covariance no per-correlation covariance is held
        # (vega_tpu/data.py:74-77)
        if self._distortion_mat is None:
            self._distortion_mat = np.eye(self.full_data_size)
        if self._cov_mat is None and not corr_item.low_mem_mode:
            self._cov_mat = np.eye(self.full_data_size)
        # per-bin variance for the results file's _VAR column
        self.variance = (np.ones(self.full_data_size)
                         if corr_item.low_mem_mode
                         else self._cov_mat.diagonal().copy())
        # the covariance as read, for the plots (vega_tpu/data.py:75-79):
        # an alias until the marginalization's update, which copies it
        # first
        self.cov_mat_org = None if corr_item.low_mem_mode else self._cov_mat
        self.masked_data_vec = self.data_vec[self.data_mask]

        # small-scale marginalization (vega_tpu/data.py:81-86)
        self.marg_templates = None
        self.cov_marg_update = None
        self.marg_diff2coeff_matrix = None
        self.num_marg_modes = 0
        if corr_item.marginalize_small_scales:
            self._init_marginalization(marginalize_in_fit)

        # Monte-Carlo state (vega_tpu/data.py:88-91)
        self._cholesky = None
        self._scale = 1.
        self.scaled_inv_masked_cov = None
        self.scaled_log_cov_det = None
        self.effective_data_size = self.data_size - self.num_marg_modes

    def _wire_corr_item(self, corr_item):
        """Hand the metal grids and matrices read here, the broadband's
        model binning and the FITS header's cosmology to the
        CorrelationItem (vega_tpu/data.py:94-108)."""
        if 'metals' in corr_item.config:
            metal_config = corr_item.config['metals']
            if corr_item.new_metals:
                in1, in2, catalog = self._init_metal_tracers(metal_config)
                pairs = self._init_metal_correlations(metal_config, in1, in2)
            else:
                catalog, pairs = self._init_metals(metal_config)
            corr_item.init_metals(catalog, pairs)
        if 'broadband' in corr_item.config:
            corr_item.init_broadband(self.coeff_binning_model)
        if self.cosmo_params is not None:
            corr_item.init_cosmo(self.cosmo_params)

    def _init_marginalization(self, marginalize_in_fit):
        """The distorted templates, the covariance update (on the
        data-mask block, unless `marginalize_in_fit`) and the coefficient
        matrix (T' C^-1 T + P)^-1 T' C^-1 from the inverse covariance
        before the update, the prior P = sigma^-2 left out when both
        fit-marginalized-scales and marginalize-match-data-bins are set
        (vega_tpu/data.py:110-140)."""
        self.marg_templates, self.cov_marg_update = \
            self.get_dist_xi_marg_templates()

        # the inverse of the covariance before the update, on the masks
        # the templates may have widened
        self._inv_masked_cov = None
        invcov_pre = self.inv_masked_cov
        self._inv_masked_cov = None

        if marginalize_in_fit:
            self.cov_marg_update = None
        else:
            if self.cov_mat_org is self._cov_mat:
                self.cov_mat_org = self._cov_mat.copy()
            self._cov_mat[np.ix_(self.data_mask, self.data_mask)] += \
                self.cov_marg_update

        templates_masked = self.marg_templates[self.model_mask, :]
        g_mat = templates_masked.T.dot(invcov_pre)
        a_mat = templates_masked.T.dot(g_mat.T).T
        if not (self.corr_item.fit_marg_scales
                and self.corr_item.marginalize_match_data_bins):
            prior = self.corr_item.marginalize_small_scales_prior_sigma
            a_mat = a_mat + np.diag(np.full(
                self.marg_templates.shape[1], prior ** -2))
        self.marg_diff2coeff_matrix = np.linalg.inv(a_mat).dot(g_mat)

    def get_dist_xi_marg_templates(self, factor=1e-8, return_AAT=True):
        """(templates, covariance update): the undistorted templates
        through the distortion matrix, the data and model masks widened
        to the marginalized bins with fit-marginalized-scales (the two
        must then keep the same size), and sigma^2 U S^2 U' of the
        masked templates' SVD, modes below `factor` of the largest
        dropped (vega_tpu/data.py:482-525)."""
        if not self.corr_item.marginalize_small_scales:
            raise ValueError('Marginalization not configured')
        if not self.has_distortion:
            raise ValueError('Distortion matrix required for marginalization')

        templates = self.corr_item.get_undist_xi_marg_templates()
        templates = self.distortion_mat.dot(templates)

        if self.corr_item.fit_marg_scales:
            self.data_mask |= \
                self.data_coordinates.get_mask_marginalization_scales(
                    self.corr_item.config['cuts'],
                    self.corr_item.marginalize_small_scales)
            self.model_mask |= \
                self.dist_model_coordinates.get_mask_marginalization_scales(
                    self.corr_item.config['cuts'],
                    self.corr_item.marginalize_small_scales)
            if self.data_mask.sum() != self.model_mask.sum():
                raise ValueError(
                    'Data and model masks should be the same after '
                    'marginalization scale cuts. Check rp-min for '
                    'cross-correlations.')
            self.masked_data_vec = self.data_vec[self.data_mask]

        if not return_AAT:
            return templates

        t = templates * self.corr_item.marginalize_small_scales_prior_sigma
        t = t[self.model_mask, :]
        print(f'  There are {templates.shape[1]} templates. '
              'SVD of template matrix to remove degenerate modes.')
        u, s, _ = np.linalg.svd(t, full_matrices=False)
        w = s > factor * s[0]
        u = u[:, w]
        s = s[w]
        print(f'  There are {w.sum()} remaining modes for marginalization.')
        self.num_marg_modes = int(w.sum())
        cov_update = np.dot(u * s ** 2, u.T)
        return templates, cov_update

    def _require(self, attr, kind):
        """The matrix `attr`, or vega_tpu's AttributeError where it is
        not held (the covariance under low_mem_mode beside a global
        covariance; vega_tpu/data.py:145-151)."""
        mat = getattr(self, attr)
        if mat is None:
            raise AttributeError(
                f'No {kind} found. Check the data file: ',
                self.corr_item.config['data'].get('filename'))
        return mat

    @property
    def cov_mat(self):
        return self._require('_cov_mat', 'covariance matrix')

    @property
    def distortion_mat(self):
        return self._require('_distortion_mat', 'distortion matrix')

    @property
    def has_cov_mat(self):
        return self._cov_mat is not None

    @property
    def has_cov_mat_org(self):
        return self.cov_mat_org is not None

    @property
    def has_distortion(self):
        return self._distortion_mat is not None

    @property
    def data_size(self):
        return self.masked_data_vec.size

    @property
    def inv_masked_cov(self):
        if self._inv_masked_cov is None:
            self._inv_masked_cov = compute_masked_invcov(
                self.cov_mat, self.data_mask)
        return self._inv_masked_cov

    @property
    def log_cov_det(self):
        if self._log_cov_det is None:
            self._log_cov_det = compute_log_cov_det(
                self.cov_mat, self.data_mask)
        return self._log_cov_det

    # ------------------------------------------------------------------
    # Monte Carlo (vega_tpu/data.py:429-477)
    # ------------------------------------------------------------------
    def set_cov_scale(self, scale):
        """Track the active covariance rescale for the chi^2 side
        (scaled inverse covariance and log-determinant). Returns True
        when the scale actually changed."""
        changed = not np.isclose(scale, self._scale)
        if changed:
            self._scale = scale
            self.scaled_inv_masked_cov = self.inv_masked_cov / scale
            self.scaled_log_cov_det = self.log_cov_det + np.log(scale)
        elif self.scaled_inv_masked_cov is None:
            # first call at the default scale: the "scaled" views are
            # simply the unscaled ones
            self.scaled_inv_masked_cov = self.inv_masked_cov
            self.scaled_log_cov_det = self.log_cov_det
        return changed

    def create_monte_carlo(self, fiducial_model, scale=None, seed=None,
                           forecast=False):
        """One Cholesky mock of the data (fiducial + L @ N(0, 1) from the
        numpy global RNG, seeded with `seed` when given); forecast=True
        gives the noiseless fiducial. Sets mc_mock (full grid, NaN outside
        the mask when only the masked covariance is factored) and
        masked_mc_mock."""
        rescaled = self.set_cov_scale(1 if scale is None else scale)
        fiducial = mocks.match_to_data_grid(fiducial_model, self)

        if forecast:
            if seed is not None:
                np.random.seed(seed)
            self.mc_mock = fiducial
        else:
            if self._cholesky is None or rescaled:
                self._cholesky = mocks.scaled_cholesky(
                    self.cov_mat, self._scale,
                    mask=self.data_mask if self.cholesky_masked_cov
                    else None)
            if seed is not None:
                np.random.seed(seed)
            if self.cholesky_masked_cov:
                # noise only on the unmasked bins; everything else NaN
                self.mc_mock = np.full(self.full_data_size, np.nan)
                self.mc_mock[self.data_mask] = mocks.gaussian_draw(
                    fiducial[self.data_mask], self._cholesky)
            else:
                self.mc_mock = mocks.gaussian_draw(fiducial, self._cholesky)

        self.masked_mc_mock = self.mc_mock[self.data_mask]
        return self.mc_mock

    @staticmethod
    def _column(hdu_columns, *names, required=False):
        """First present column among names as float, else None."""
        for name in names:
            if name in hdu_columns:
                return hdu_columns[name].astype(float)
        if required:
            raise ValueError(
                f'None of the columns {names} found in FITS file.')
        return None

    @staticmethod
    def _coords(header, np_factor=1, **grids):
        """Coordinates from a picca-export header's binning keywords."""
        return Coordinates(
            header['RPMIN'], header['RPMAX'], header['RTMAX'],
            header['NP'] * np_factor, header['NT'] * np_factor, **grids)

    def _load_data_vector(self, columns, data_path):
        """The data vector by the file's blinding strategy, and `blind`
        (vega_tpu/data.py:218-241): none, desi_m2, desi_y1 and desi_y3
        read DA and leave `blind` False (their blinding is the
        parameters' offsets, utils.get_blinding); desi_dr3 reads the
        mandatory DA_BLIND column; any other strategy raises."""
        strat = self.blinding_strat
        if strat is None or strat in ('desi_m2', 'desi_y1', 'desi_y3'):
            self.blind = False
            self.data_vec = self._column(columns, 'DA', required=True)
            return
        if strat not in BLINDING_STRATEGIES:
            self.blind = True
            raise ValueError(f'Unknown blinding strategy {strat}.')
        print(f'Strategy: {strat}')
        self.blind = True
        if strat == 'desi_dr3' and 'DA_BLIND' not in columns:
            # vega_tpu's assertion, raised whatever python's -O says
            raise AssertionError('Blinding failed, do not run!!!')
        if 'DA_BLIND' in columns:
            print(f'Warning! Running on blinded data {data_path}')
        self.data_vec = self._column(columns, 'DA_BLIND', 'DA')
        if self.data_vec is None:
            raise ValueError('No DA or DA_BLIND column in data file.')

    def _read_data(self, data_path, cuts_config, dmat_path=None,
                   cov_path=None, cov_rescale=None):
        """(reference: data.py:285-440)"""
        print(f'Reading data file {data_path}')
        hdul = read_fits(find_file(data_path))
        header = hdul[1].header
        columns = hdul[1].columns

        strat = header.get('BLINDING', None)
        self.blinding_strat = None if strat in (None, 'none', 'None') \
            else strat
        self._load_data_vector(columns, data_path)
        self.full_data_size = len(self.data_vec)

        if dmat_path is None:
            self._distortion_mat = self._column(columns, 'DM_BLIND', 'DM')
        if cov_path is not None:
            print(f'Reading covariance matrix file {cov_path}')
            self._cov_mat = read_fits(
                find_file(cov_path))[1]['CO'].astype(float)
        else:
            self._cov_mat = self._column(columns, 'CO')
        if cov_rescale is not None and self._cov_mat is not None:
            self._cov_mat = self._cov_mat * cov_rescale

        self.nb = columns['NB'] if 'NB' in columns else None
        self.cosmo_params = None
        if 'OMEGAM' in header:
            self.cosmo_params = dict(
                Omega_m=header['OMEGAM'], Omega_k=header.get('OMEGAK', 0.),
                Omega_r=header.get('OMEGAR', 0.), wl=header.get('WL', -1.))

        self.data_coordinates = self._coords(
            header, rp_grid=columns['RP'], rt_grid=columns['RT'],
            z_grid=columns['Z'])
        self.data_mask = self.data_coordinates.get_mask_scale_cuts(cuts_config)

        self.model_coordinates = None
        self.dist_model_coordinates = None
        self.coeff_binning_model = 1
        if dmat_path is not None:
            self._read_dmat(dmat_path)
        elif len(hdul) > 2:
            # model grid shipped alongside the inline DM
            self.model_coordinates = self._coords(
                header, rp_grid=hdul[2]['DMRP'],
                rt_grid=hdul[2]['DMRT'], z_grid=hdul[2]['DMZ'])
        self.model_coordinates = (self.model_coordinates
                                  or self.data_coordinates)
        self.dist_model_coordinates = (self.dist_model_coordinates
                                       or self.model_coordinates)
        self.model_mask = self.dist_model_coordinates.get_mask_scale_cuts(
            cuts_config)
        # the r cuts as configured, for the plots (vega_tpu/data.py:295)
        self.r_min_cut = cuts_config.getfloat('r-min', 10.)
        self.r_max_cut = cuts_config.getfloat('r-max', 180.)

    # ------------------------------------------------------------------
    # Metals (vega_tpu/data.py:328-424)
    # ------------------------------------------------------------------
    def _metal_lists(self, metal_config):
        """The 'in tracer1' / 'in tracer2' metal name lists (None when
        the side is absent)."""
        if not ('in tracer1' in metal_config or 'in tracer2' in metal_config):
            raise ValueError("The metals config must specify 'in tracer1' "
                             "and/or 'in tracer2'")
        return tuple(
            metal_config.get(side).split() if side in metal_config else None
            for side in ('in tracer1', 'in tracer2'))

    def _init_metal_tracers(self, metal_config):
        in1, in2 = self._metal_lists(metal_config)
        tracer_catalog = {
            self.tracer1['name']: self.tracer1,
            self.tracer2['name']: self.tracer2,
        }
        for metal in (in1 or []) + (in2 or []):
            tracer_catalog[metal] = {'name': metal, 'type': 'continuous'}
        return in1, in2, tracer_catalog

    def _metal_pairs(self, in1, in2):
        """Every metal correlation pair this component needs, in the
        reference's order: main1 x (in2), (in1) x main2, then the
        metal x metal block with the symmetric half skipped for autos
        (reference: data.py:556-630 loop structure)."""
        pairs = []
        for metal in in2 or []:
            pairs.append((self.tracer1['name'], metal))
        for metal in in1 or []:
            pairs.append((metal, self.tracer2['name']))
        if in1 and in2:
            is_auto = self.tracer1 == self.tracer2
            for i, metal1 in enumerate(in1):
                for metal2 in in2[i if is_auto else 0:]:
                    pairs.append((metal1, metal2))
        return [p for p in pairs if self._use_correlation(*p)]

    def _init_metal_correlations(self, metal_config, in1, in2):
        """The pair list alone: in the new-metals mode the matrices are
        computed, not read (vega_tpu/data.py:363-366)."""
        return self._metal_pairs(in1, in2)

    def _init_metals(self, metal_config):
        """Legacy mode: metal coordinates, and distortion matrices where
        the file has them, read from a picca metal FITS file."""
        in1, in2, tracer_catalog = self._init_metal_tracers(metal_config)

        self.metal_mats = {}
        self.metal_coordinates = {}

        metal_hdul = read_fits(find_file(metal_config.get('filename')))
        blinded = metal_hdul[1].header.get('BLINDING', 'none') != 'none'
        dm_prefix = 'DM_BLIND_' if blinded else 'DM_'

        metal_correlations = self._metal_pairs(in1, in2)
        for tracers in metal_correlations:
            # column names may carry the pair in either order
            name = '_'.join(tracers)
            if 'RP_' + name not in metal_hdul[2].columns:
                name = '_'.join(reversed(tracers))
            self._read_metal_correlation(metal_hdul, tracers, name,
                                         dm_prefix)
        return tracer_catalog, metal_correlations

    def _use_correlation(self, name1, name2):
        """(reference: data.py:632-653)"""
        if name1 == 'CIV(eff)' or name2 == 'CIV(eff)':
            return name1 == name2
        if 'SiII' in name1 and 'SiII' in name2 and not self.use_metal_autos:
            return False
        return True

    def _read_metal_correlation(self, metal_hdul, tracers, name, dm_prefix):
        """(reference: data.py:655-687)"""
        header = metal_hdul[1].header
        self.metal_coordinates[tracers] = Coordinates(
            header['RPMIN'], header['RPMAX'], header['RTMAX'],
            header['NP'], header['NT'],
            rp_grid=metal_hdul[2]['RP_' + name],
            rt_grid=metal_hdul[2]['RT_' + name],
            z_grid=metal_hdul[2]['Z_' + name])

        dm_name = dm_prefix + name
        if dm_name in metal_hdul[2].columns:
            self.metal_mats[tracers] = metal_hdul[2][dm_name].astype(float)
        elif len(metal_hdul) > 3 and dm_name in metal_hdul[3].columns:
            self.metal_mats[tracers] = metal_hdul[3][dm_name].astype(float)
        elif self.corr_item.test_flag:
            # identity metal matrix: None, so the model skips the matmul
            # (the reference multiplies by sparse.eye)
            self.metal_mats[tracers] = None
        else:
            raise ValueError('Cannot find correct metal matrices. Check that '
                             'blinding is consistent between cf and metal '
                             'files.')

    def _read_dmat(self, dmat_path):
        """Separate distortion-matrix file (reference: data.py:441-473)."""
        print(f'Reading distortion matrix file {dmat_path}')
        hdul = read_fits(find_file(dmat_path))
        header = hdul[1].header
        self._distortion_mat = self._column(hdul[1].columns, 'DM', 'DM_BLIND')
        if self._distortion_mat is None:
            raise ValueError('No DM or DM_BLIND column in distortion file.')
        self.coeff_binning_model = header['COEFMOD']
        self.model_coordinates = self._coords(
            header, np_factor=self.coeff_binning_model,
            rp_grid=hdul[2]['RP'], rt_grid=hdul[2]['RT'],
            z_grid=hdul[2]['Z'])
        self.dist_model_coordinates = self._coords(header)
