"""Programmatic config generation: `BuildConfig` writes the main and
per-correlation INI files of a fit from options, correlation files and
the names to sample.

A copy of vega_tpu/build_config.py (host code: ConfigParser, numpy and
the FITS reader), pinned to it by tests/test_torch_config_tools.py: the
same arguments write the same files, apart from the date line and the
git-hash line, which names this package. The per-correlation templates
come from a tracer table (`make_correlation_template`); the parameter
defaults are read from the JAX package's templates/parameter_defaults.ini
by filesystem path.
"""

from __future__ import annotations

import copy
import os
import subprocess
from configparser import ConfigParser
from datetime import datetime
from pathlib import Path

import numpy as np

from .io.fits import read_fits
from .utils import JAX_PACKAGE_DIR, find_file

# tracer name -> (vega tracer label, tracer type)
TRACERS = {
    'lya': ('LYA', 'continuous'),
    'lyb': ('LYA', 'continuous'),   # LYB region deltas still trace LYA
    'qso': ('QSO', 'discrete'),
    'dla': ('DLA', 'discrete'),
    'sbla': ('SBLA', 'discrete'),
    'civ': ('CIV', 'continuous'),
}

DEFAULT_METALS = ['SiII(1190)', 'SiII(1193)', 'SiIII(1207)', 'SiII(1260)',
                  'CIV(eff)']


def make_correlation_template(name):
    """Generate the per-correlation template config for a fit-type
    component like 'lyaxqso' (replaces the reference's static
    vega/templates/<name>.ini files)."""
    parts = name.split('x')
    if len(parts) != 2 or parts[0] not in TRACERS or parts[1] not in TRACERS:
        raise ValueError(f'Unknown correlation {name}.')
    (t1, type1), (t2, type2) = TRACERS[parts[0]], TRACERS[parts[1]]

    config = ConfigParser()
    config.optionxform = lambda option: option
    config['data'] = {
        'name': name, 'tracer1': t1, 'tracer2': t2,
        'tracer1-type': type1, 'tracer2-type': type2, 'filename': 'path',
    }
    config['cuts'] = {
        'rp-min': '-300.', 'rp-max': '+300.', 'rt-min': '0.',
        'rt-max': '300.', 'r-min': '10.', 'r-max': '180.',
        'mu-min': '-1.', 'mu-max': '+1.',
    }
    config['model'] = {}
    for tracer in dict.fromkeys([t1, t2]):
        config['model'][f'z evol {tracer}'] = 'bias_vs_z_std'
    return config


class BuildConfig:
    """Build and manage config files (reference: build_config.py:15-220)."""

    _params_template = None
    recognised_correlations = [
        'lyaxlya', 'lyaxlyb', 'lyaxqso', 'lybxqso',
        'lyaxdla', 'lybxdla', 'lyaxsbla', 'lybxsbla',
        'qsoxqso', 'qsoxdla', 'dlaxdla',
        'civxciv', 'civxqso', 'civxlya',
    ]

    def __init__(self, options=None, overwrite=False):
        options = options or {}
        self.overwrite = overwrite
        self.options = {}
        opt = self.options

        opt['scale_params'] = options.get('scale_params', 'ap_at')
        opt['template'] = options.get('template',
                                      'PlanckDR16/PlanckDR16.fits')
        opt['full_shape'] = options.get('full_shape', False)
        opt['full_shape_alpha'] = options.get('full_shape_alpha', False)
        opt['smooth_scaling'] = options.get('smooth_scaling', False)

        opt['small_scale_nl'] = options.get('small_scale_nl', False)
        opt['small_scale_nl_cross'] = options.get('small_scale_nl_cross',
                                                  False)
        opt['bao_broadening'] = options.get('bao_broadening', False)
        opt['skip-nl-model-in-peak'] = options.get('skip-nl-model-in-peak',
                                                   False)
        opt['UVB-fluctuations'] = options.get('UVB-fluctuations', False)
        opt['UVB-SN-cross'] = options.get('UVB-SN-cross', False)
        opt['HeII-reionization'] = options.get('HeII-reionization', False)
        opt['mock-bin-size'] = options.get('mock-bin-size', None)
        opt['mock-los-smoothing'] = options.get('mock-los-smoothing', None)

        opt['velocity_dispersion'] = options.get('velocity_dispersion', None)
        opt['radiation_effects'] = options.get('radiation_effects', False)
        opt['pk-damping-scale'] = options.get('pk-damping-scale', None)
        opt['pk-damping-power'] = options.get('pk-damping-power', 2)

        for key in ['marginalize-below-rtmax', 'marginalize-above-rtmin',
                    'marginalize-below-rpmax', 'marginalize-above-rpmin']:
            opt[key] = options.get(key, None)
        opt['marginalize-all-rmin-cuts'] = options.get(
            'marginalize-all-rmin-cuts', False)
        opt['marginalize-prior-sigma'] = options.get(
            'marginalize-prior-sigma', 10.0)
        opt['fit-marginalized-scales'] = options.get(
            'fit-marginalized-scales', True)
        opt['marginalize-match-data-bins'] = options.get(
            'marginalize-match-data-bins', True)

        opt['hcd_model'] = options.get('hcd_model', None)
        opt['fvoigt_model'] = options.get('fvoigt_model', 'exp')
        opt['fullshape_smoothing'] = options.get('fullshape_smoothing', None)
        opt['fullshape_smoothing_metals'] = options.get(
            'fullshape_smoothing_metals', False)
        opt['desi-instrumental-systematics'] = options.get(
            'desi-instrumental-systematics', False)
        opt['test'] = options.get('test', False)
        opt['use_metal_autos'] = options.get('use_metal_autos', True)
        opt['new_metals'] = options.get('new_metals', False)
        opt['rp_only_metal_mats'] = options.get('rp_only_metal_mats', False)
        opt['metal-matrix'] = options.get('metal-matrix', {})
        opt['rebin-metals'] = options.get('rebin-metals', None)
        opt['use_metal_bias_eta'] = options.get('use_metal_bias_eta', False)
        opt['separate-metal-auto-biases'] = options.get(
            'separate-metal-auto-biases', False)
        opt['single-metal-beta'] = options.get('single-metal-beta', False)
        opt['zmin'] = options.get('zmin', 0.0)
        opt['zmax'] = options.get('zmax', 10.0)

        metals = options.get('metals', None)
        if metals is not None and 'all' in metals:
            metals = list(DEFAULT_METALS)
        opt['metals'] = metals

    # ------------------------------------------------------------------
    def build(self, correlations, fit_type, fit_info, out_path,
              parameters=None, name_extension=None):
        """Build the main + per-correlation config files
        (reference: build_config.py:115-220)."""
        parameters = parameters or {}
        self.fit_info = fit_info
        self.name_extension = name_extension

        self.fitter = fit_info.get('fitter', True)
        self.run_sampler = fit_info.get('run_sampler', False)

        self.config_path = Path(os.path.expandvars(out_path))
        assert self.config_path.is_dir()
        if self.fitter:
            self.fitter_out_path = self.config_path / 'output_fitter'
            self.fitter_out_path.mkdir(exist_ok=True)
        if self.run_sampler:
            self.sampler = fit_info.get('sampler', 'Polychord')
            self.sampler_out_path = self.config_path / 'output_sampler'
            self.sampler_out_path.mkdir(exist_ok=True)

        components = fit_type.split('_')
        for corr in components:
            if corr not in self.recognised_correlations:
                raise ValueError(f'Unknown correlation {corr}, part of fit '
                                 f'type {fit_type}.')
        if len(components) != len(set(components)):
            print(f'Warning! fit type {fit_type} has duplicates')

        git_hash = self._get_git_hash()

        self.corr_paths = []
        self.corr_names = []
        self.data_paths = []
        for name in components:
            if name not in correlations:
                raise ValueError(f'You asked for correlation {name} but did '
                                 'not provide its configuration.')
            corr_path, data_path, tracer1, tracer2 = self._build_corr_config(
                name, correlations[name], git_hash)
            self.corr_paths.append(corr_path)
            self.data_paths.append(data_path)
            for tracer in (tracer1, tracer2):
                if tracer not in self.corr_names:
                    self.corr_names.append(tracer)

        return self._build_main_config(fit_type, fit_info, parameters,
                                       git_hash)

    @staticmethod
    def _get_git_hash():
        try:
            pkg_dir = Path(os.path.dirname(__file__)).parents[0]
            return subprocess.run(
                ['git', 'rev-parse', 'HEAD'], cwd=pkg_dir,
                capture_output=True, text=True, timeout=5
            ).stdout.strip() or 'None'
        except Exception:
            return 'None'

    # ------------------------------------------------------------------
    def _build_corr_config(self, name, corr_info, git_hash):
        """Per-correlation config (reference: build_config.py:222-454)."""
        config = make_correlation_template(name)
        opt = self.options

        tracer1 = config['data']['tracer1']
        tracer2 = config['data']['tracer2']
        type1 = config['data']['tracer1-type']
        type2 = config['data']['tracer2-type']

        config['data']['filename'] = corr_info.get('corr_path')
        for key in ['distortion-file', 'covariance-file', 'cov_rescale']:
            if key in corr_info:
                config['data'][key] = str(corr_info.get(key))

        config['cuts']['r-min'] = str(corr_info.get('r-min', 10))
        config['cuts']['r-max'] = str(corr_info.get('r-max', 180))
        config['cuts']['rt-min'] = str(corr_info.get('rt-min', 0))
        config['cuts']['rp-min'] = str(corr_info.get('rp-min', -300))
        config['cuts']['mu-min'] = str(corr_info.get('mu-min', -1))
        config['cuts']['mu-max'] = str(corr_info.get('mu-max', 1))
        if opt['test']:
            config['data']['test'] = 'True'

        if 'binsize' in corr_info:
            config['parameters'] = {
                f'par binsize {name}': str(corr_info.get('binsize', 4)),
                f'per binsize {name}': str(corr_info.get('binsize', 4)),
            }

        # Things that require LYA
        if tracer1 == 'LYA' and tracer2 == 'LYA':
            if opt['small_scale_nl']:
                config['model']['small scale nl'] = 'dnl_arinyo'
        elif 'LYA' in (tracer1, tracer2):
            if opt['small_scale_nl_cross']:
                config['model']['small scale nl'] = 'dnl_arinyo'

        # Both tracers continuous
        if type1 == 'continuous' and type2 == 'continuous':
            config['model']['use_metal_autos'] = str(opt['use_metal_autos'])
            if opt['desi-instrumental-systematics']:
                config['model']['desi-instrumental-systematics'] = 'True'

        # At least one continuous tracer
        if type1 == 'continuous' or type2 == 'continuous':
            if opt['UVB-fluctuations']:
                config['model']['UVB-fluctuations'] = 'True'
                if type1 == type2 or opt['UVB-SN-cross']:
                    config['model']['UVB-shotnoise'] = 'True'

            if opt['HeII-reionization']:
                config['model']['HeII-reionization'] = 'True'

            if opt['hcd_model'] is not None:
                assert opt['hcd_model'] in ['fvoigt', 'Rogers2018', 'sinc']
                config['model']['model-hcd'] = opt['hcd_model']
                if opt['hcd_model'] == 'fvoigt':
                    config['model']['fvoigt_model'] = opt['fvoigt_model']

            if opt['metals'] is not None:
                config['metals'] = {
                    'filename': corr_info.get('metal_path', 'None'),
                    'z evol': 'bias_vs_z_std',
                }
                if type1 == 'continuous':
                    config['metals']['in tracer1'] = ' '.join(opt['metals'])
                if type2 == 'continuous':
                    config['metals']['in tracer2'] = ' '.join(opt['metals'])

                if 'fast_metals' in corr_info:
                    config['model']['fast_metals'] = corr_info.get(
                        'fast_metals', 'False')
                if opt['separate-metal-auto-biases']:
                    config['model']['separate-metal-auto-biases'] = 'True'
                if opt['single-metal-beta']:
                    config['model']['single-metal-beta'] = 'True'

                if opt.get('new_metals', False):
                    config['model']['new_metals'] = 'True'
                    config['model']['rp_only_metal_mats'] = str(
                        opt['rp_only_metal_mats'])
                    config['data']['weights-tracer1'] = corr_info.get(
                        'weights-tracer1')
                    config['data']['weights-tracer2'] = corr_info.get(
                        'weights-tracer2')
                    config['data']['zmin'] = str(opt.get('zmin'))
                    config['data']['zmax'] = str(opt.get('zmax'))

                    mm = dict(opt['metal-matrix'])
                    config['metal-matrix'] = {}
                    if opt['rebin-metals'] is not None:
                        config['metal-matrix']['rebin_factor'] = str(
                            int(opt['rebin-metals']))
                    else:
                        config['metal-matrix']['rebin_factor'] = mm.get(
                            'rebin_factor', '3')
                    defaults = {
                        'alpha_LYA': '2.9', 'alpha_SiII(1260)': '1.',
                        'alpha_SiIII(1207)': '1.', 'alpha_SiII(1193)': '1.',
                        'alpha_SiII(1190)': '1.', 'alpha_CIV(eff)': '0.',
                        'z_ref_objects': '2.25', 'z_evol_objects': '1.44',
                        'z_bins_objects': '1000',
                    }
                    for key, default in defaults.items():
                        config['metal-matrix'][key] = mm.get(key, default)

        # At least one discrete tracer
        if type1 == 'discrete' or type2 == 'discrete':
            if opt['velocity_dispersion'] is not None:
                assert opt['velocity_dispersion'] in ['lorentz', 'gauss']
                config['model']['velocity dispersion'] = \
                    opt['velocity_dispersion']
                if opt['metals'] is not None and type1 != type2:
                    config['metals']['velocity dispersion'] = \
                        opt['velocity_dispersion']

        # LYA-QSO cross only
        if 'LYA' in (tracer1, tracer2) and 'QSO' in (tracer1, tracer2):
            if opt['radiation_effects']:
                config['model']['radiation effects'] = 'True'

        # Small-scale marginalization
        has_marg = False
        for key in ['marginalize-below-rtmax', 'marginalize-above-rtmin',
                    'marginalize-below-rpmax', 'marginalize-above-rpmin']:
            if opt[key] is not None:
                config['model'][key] = str(opt[key])
                has_marg = True
        config['model']['marginalize-all-rmin-cuts'] = str(
            opt['marginalize-all-rmin-cuts'])
        if has_marg or opt['marginalize-all-rmin-cuts']:
            config['model']['marginalize-prior-sigma'] = str(
                opt['marginalize-prior-sigma'])
            config['model']['fit-marginalized-scales'] = str(
                opt['fit-marginalized-scales'])
            config['model']['marginalize-match-data-bins'] = str(
                opt['marginalize-match-data-bins'])

        if opt['skip-nl-model-in-peak']:
            config['model']['skip-nl-model-in-peak'] = str(
                opt['skip-nl-model-in-peak'])

        if opt['pk-damping-scale'] is not None:
            config['model']['pk-damping-scale'] = str(opt['pk-damping-scale'])
            config['model']['pk-damping-power'] = str(opt['pk-damping-power'])

        if 'broadband' in corr_info:
            config['broadband'] = {}
            for key, item in corr_info['broadband'].items():
                config['broadband'][key] = item

        # Free-form per-correlation [model] overrides (e.g. the DR16
        # analysis' old_fftlog / old_growth_func compatibility switches)
        for key, item in corr_info.get('extra-model', {}).items():
            config['model'][key] = str(item)

        if opt['fullshape_smoothing'] is not None:
            assert opt['fullshape_smoothing'] in ['gauss', 'gauss_iso', 'exp']
            config['model']['fullshape smoothing'] = \
                opt['fullshape_smoothing']
            condition = (type1 == 'continuous' or type2 == 'continuous')
            condition &= opt['metals'] is not None
            condition &= opt['fullshape_smoothing_metals']
            if condition:
                config['metals']['fullshape smoothing'] = \
                    opt['fullshape_smoothing']

        if opt['mock-bin-size'] is not None:
            config['model']['mock-bin-size'] = str(opt['mock-bin-size'])
            if opt['metals'] is not None:
                config['metals']['mock-bin-size'] = str(opt['mock-bin-size'])
            if opt['mock-los-smoothing'] is not None:
                config['model']['mock-los-smoothing'] = \
                    opt['mock-los-smoothing']
                if opt['metals'] is not None:
                    config['metals']['mock-los-smoothing'] = \
                        opt['mock-los-smoothing']

        if self.name_extension is None:
            corr_path = self.config_path / f'{name}.ini'
        else:
            corr_path = self.config_path / f'{name}-{self.name_extension}.ini'
        if corr_path.is_file() and not self.overwrite:
            raise ValueError(f'File {corr_path} already exists. Please '
                             'change the name extension.')

        with open(corr_path, 'w') as configfile:
            configfile.write(f'# File written on {datetime.now()} \n')
            configfile.write(f'# vega_tpu_torch git hash: {git_hash} \n\n')
            config.write(configfile)

        return corr_path, config['data']['filename'], tracer1, tracer2

    # ------------------------------------------------------------------
    @staticmethod
    def get_zeff(data_paths, rmin=0., rmax=300.):
        """Inverse-variance-weighted effective redshift
        (reference: build_config.py:456-492)."""
        zeff_list = []
        weights = []
        for path in data_paths:
            hdul = read_fits(find_file(path))
            r_arr = np.sqrt(hdul[1]['RP'] ** 2 + hdul[1]['RT'] ** 2)
            cells = (r_arr > rmin) & (r_arr < rmax)
            inverse_variance = 1 / np.diag(hdul[1]['CO'])
            zeff = np.average(hdul[1]['Z'][cells],
                              weights=inverse_variance[cells])
            zeff_list.append(zeff)
            weights.append(np.sum(inverse_variance[cells]))
        return np.average(zeff_list, weights=weights)

    def _build_main_config(self, fit_type, fit_info, parameters, git_hash):
        """Main config (reference: build_config.py:494-673)."""
        config = ConfigParser()
        config.optionxform = lambda option: option

        self.zeff_in = fit_info.get('zeff', None)
        zeff_rmin = float(fit_info.get('zeff_rmin', 0.))
        zeff_rmax = float(fit_info.get('zeff_rmax', 300.))
        if self.zeff_in is None:
            self.zeff_in = self.get_zeff(self.data_paths, zeff_rmin,
                                         zeff_rmax)
        self.zeff_in = float(self.zeff_in)

        config['data sets'] = {
            'zeff': str(self.zeff_in),
            'ini files': ' '.join(str(p) for p in self.corr_paths),
        }
        if 'global_cov_file' in fit_info:
            config['data sets']['global-cov-file'] = fit_info.get(
                'global_cov_file')

        config['cosmo-fit type'] = {
            'cosmo fit func': self.options['scale_params'],
            'full-shape': str(self.options['full_shape']),
            'full-shape-alpha': str(self.options['full_shape_alpha']),
            'smooth-scaling': str(self.options['smooth_scaling']),
        }
        config['fiducial'] = {'filename': self.options['template']}

        run_name = fit_type
        if self.name_extension is not None:
            run_name += f'-{self.name_extension}'
        config['output'] = {'filename': str(self.fitter_out_path / run_name)}

        sample_params = fit_info['sample_params']
        config['sample'] = {}
        if isinstance(sample_params, list):
            for param in sample_params:
                config['sample'][param] = 'True'
        elif isinstance(sample_params, dict):
            for param, setup in sample_params.items():
                config['sample'][param] = setup
        else:
            raise TypeError('sample_params must be a list or a dict.')

        if 'priors' in fit_info:
            config['priors'] = {}
            for par, prior in fit_info['priors'].items():
                assert par in config['sample'], \
                    'Cannot add prior for parameter that is not sampled'
                config['priors'][par] = prior

        self.parameters = parameters
        config['parameters'] = {name: str(value)
                                for name, value in self.parameters.items()}

        for param in sample_params:
            if param not in config['parameters']:
                raise ValueError(f'Asked for unknown parameter "{param}". '
                                 'If this is a new parameter without a '
                                 'default, pass it in the parameters dict.')

        config['control'] = {'run_sampler': 'False'}
        if 'use_template_growth_rate' in fit_info:
            config['control']['use_template_growth_rate'] = \
                fit_info['use_template_growth_rate']
        if self.run_sampler:
            config['control']['run_sampler'] = 'True'
            config['control']['sampler'] = self.sampler
            config['control']['low_mem_mode'] = fit_info.get('low_mem_mode',
                                                             'False')
            if self.sampler == 'Polychord':
                pc = fit_info.get('Polychord', {})
                config['Polychord'] = {
                    'path': str(self.sampler_out_path), 'name': run_name,
                    'num_live': pc.get('num_live',
                                       str(25 * len(sample_params))),
                    'num_repeats': pc.get('num_repeats',
                                          str(len(sample_params))),
                    'do_clustering': pc.get('do_clustering', 'True'),
                    'boost_posterior': pc.get('boost_posterior', str(0)),
                }
            elif self.sampler == 'PocoMC':
                pm = fit_info.get('PocoMC', {})
                config['PocoMC'] = {
                    'path': str(self.sampler_out_path), 'name': run_name,
                    'precondition': pm.get('precondition', 'True'),
                    'dynamic': pm.get('dynamic', 'False'),
                    'n_effective': pm.get('n_effective', '512'),
                    'n_active': pm.get('n_active', '256'),
                    'n_total': pm.get('n_total', '1024'),
                    'n_evidence': pm.get('n_evidence', '0'),
                    'save_every': pm.get('save_every', '3'),
                    'use_mpi': pm.get('use_mpi', 'True'),
                    'num_cpu': pm.get('num_cpu', '64'),
                }
            elif self.sampler == 'NestedJax':
                nj = fit_info.get('NestedJax', {})
                config['NestedJax'] = {
                    'path': str(self.sampler_out_path), 'name': run_name,
                    'num_live': nj.get('num_live',
                                       str(25 * len(sample_params))),
                }
            elif self.sampler == 'HMC':
                hm = fit_info.get('HMC', {})
                config['HMC'] = {
                    'path': str(self.sampler_out_path), 'name': run_name,
                    'num_chains': hm.get('num_chains', '32'),
                    'num_samples': hm.get('num_samples', '1000'),
                    'num_warmup': hm.get('num_warmup', '500'),
                    'num_leapfrog': hm.get('num_leapfrog', '16'),
                }
            else:
                raise ValueError(f'Sampler {self.sampler} is not supported. '
                                 'Choose Polychord, PocoMC, NestedJax or '
                                 'HMC.')

        if 'monte_carlo' in fit_info:
            mc = fit_info['monte_carlo']
            config['mc parameters'] = {
                key: str(value) for key, value in mc['parameters'].items()}
            config['control']['run_montecarlo'] = 'True'
            if 'forecast' in mc:
                config['control']['forecast'] = str(mc['forecast'])
            if 'global_cov_rescale' in mc:
                config['control']['global_cov_rescale'] = str(
                    mc['global_cov_rescale'])
            if 'mc_output' in mc:
                config['output']['mc_output'] = str(mc['mc_output'])
            if 'num_mc_mocks' in mc:
                config['control']['num_mc_mocks'] = str(mc['num_mc_mocks'])
            if 'mc_seed' in mc:
                config['control']['mc_seed'] = str(mc['mc_seed'])
            if 'run_mc_fits' in mc:
                config['control']['run_mc_fits'] = str(mc['run_mc_fits'])
            config['monte carlo'] = copy.deepcopy(config['sample'])
            config['sample'] = {}

        if self.name_extension is None:
            main_path = self.config_path / 'main.ini'
        else:
            main_path = self.config_path / f'main-{self.name_extension}.ini'
        if main_path.is_file() and not self.overwrite:
            raise ValueError(f'File {main_path} already exists. Please '
                             'change the name extension.')

        with open(main_path, 'w') as configfile:
            configfile.write(f'# File written on {datetime.now()} \n')
            configfile.write(f'# vega_tpu_torch git hash: {git_hash} \n\n')
            config.write(configfile)

        return main_path

    # ------------------------------------------------------------------
    @property
    def parameters(self):
        return self._parameters

    @parameters.setter
    def parameters(self, parameters):
        """Resolve defaults for all parameters the requested model options
        need (reference: build_config.py:686-896)."""
        if self._params_template is None:
            config = ConfigParser()
            config.optionxform = lambda option: option
            config.read(JAX_PACKAGE_DIR / 'templates'
                        / 'parameter_defaults.ini')
            self._params_template = config['parameters']

        opt = self.options

        def get_par(name):
            if name in parameters:
                return parameters[name]
            if name not in self._params_template:
                raise ValueError(f'Unknown parameter: {name}, please pass a '
                                 'default value.')
            return self._params_template[name]

        new_params = {}

        # Scale parameters
        if opt['scale_params'] == 'ap_at':
            new_params['ap'] = get_par('ap')
            new_params['at'] = get_par('at')
        elif opt['scale_params'] == 'phi_alpha':
            new_params['phi'] = get_par('phi')
            new_params['alpha'] = get_par('alpha')
            if opt['full_shape']:
                new_params['phi_full'] = get_par('phi_full')
            if opt['full_shape_alpha']:
                new_params['alpha_full'] = get_par('alpha_full')
            if opt['smooth_scaling']:
                new_params['phi_smooth'] = get_par('phi_smooth')
                new_params['alpha_smooth'] = get_par('alpha_smooth')
        elif opt['scale_params'] == 'aiso_epsilon':
            new_params['aiso'] = get_par('aiso')
            new_params['epsilon'] = get_par('epsilon')
        else:
            raise ValueError(
                f'Unknown scale parameters: {opt["scale_params"]}')

        # Peak parameters
        if opt['bao_broadening']:
            new_params['sigmaNL_per'] = get_par('sigmaNL_per')
            new_params['sigmaNL_par'] = get_par('sigmaNL_par')
        else:
            new_params['sigmaNL_per'] = 0.
            new_params['sigmaNL_par'] = 0.
        new_params['bao_amp'] = get_par('bao_amp')

        def add_bias_beta(tracer, bias_beta_config, bias, bias_eta, beta,
                          growth_rate):
            if bias_beta_config == 'bias_beta':
                new_params[f'bias_{tracer}'] = bias
                new_params[f'beta_{tracer}'] = beta
            elif bias_beta_config == 'bias_bias_eta':
                new_params[f'bias_{tracer}'] = bias
                new_params[f'bias_eta_{tracer}'] = bias_eta
                new_params['growth_rate'] = growth_rate
            elif bias_beta_config == 'bias_eta_beta':
                new_params[f'beta_{tracer}'] = beta
                new_params[f'bias_eta_{tracer}'] = bias_eta
                new_params['growth_rate'] = growth_rate
            else:
                raise ValueError(f'Option {bias_beta_config} not a valid '
                                 'bias_beta_config. Choose from '
                                 '["bias_beta", "bias_eta_beta", '
                                 '"bias_bias_eta"].')

        for name in self.corr_names:
            bias_beta_config = self.fit_info.get(
                'bias_beta_config', {}).get(name, 'bias_beta')
            growth_rate = parameters.get('growth_rate', None)
            if growth_rate is None:
                growth_rate = self.get_growth_rate(self.zeff_in)

            if name in ('LYA', 'LYB', 'CIV'):
                bias = parameters.get(f'bias_{name}',
                                      self.get_lya_bias(self.zeff_in))
                bias_eta = parameters.get(f'bias_eta_{name}', None)
                beta = float(get_par(f'beta_{name}'))
                if bias_eta is None:
                    bias_eta = bias * beta / growth_rate
            elif name in ('QSO', 'DLA', 'SBLA'):
                bias = parameters.get(f'bias_{name}',
                                      self.get_qso_bias(self.zeff_in))
                beta = parameters.get(f'beta_{name}', None)
                bias_eta = 1
                if beta is None:
                    beta = growth_rate / bias
            else:
                raise ValueError(f'Tracer {name} not supported yet.')

            add_bias_beta(name, bias_beta_config, bias, bias_eta, beta,
                          growth_rate)
            new_params[f'alpha_{name}'] = get_par(f'alpha_{name}')

        if opt['small_scale_nl']:
            for par in ['q1', 'q2', 'kv', 'av', 'bv', 'kp']:
                new_params[f'dnl_arinyo_{par}'] = get_par(f'dnl_arinyo_{par}')

        if opt['hcd_model'] is not None:
            new_params['bias_hcd'] = get_par('bias_hcd')
            new_params['beta_hcd'] = get_par('beta_hcd')
            new_params['L0_hcd'] = get_par('L0_hcd')

        if 'QSO' in self.corr_names:
            new_params['drp_QSO'] = get_par('drp_QSO')

        if opt['velocity_dispersion'] is not None:
            kind = ('lorentz' if opt['velocity_dispersion'] == 'lorentz'
                    else 'gauss')
            for name in self.corr_names:
                if name in ('QSO', 'DLA', 'SBLA'):
                    key = f'sigma_velo_disp_{kind}_{name}'
                    new_params[key] = get_par(key)

        if opt['radiation_effects']:
            for par in ['strength', 'asymmetry', 'lifetime', 'decrease']:
                new_params[f'qso_rad_{par}'] = get_par(f'qso_rad_{par}')

        if opt['UVB-fluctuations']:
            new_params['bias_gamma'] = get_par('bias_gamma')
            new_params['bias_prim'] = get_par('bias_prim')
            new_params['lambda_uv'] = get_par('lambda_uv')
            new_params['uv_shotnoise_amp'] = get_par('uv_shotnoise_amp')

        if opt['HeII-reionization']:
            new_params['bias_gamma_e'] = get_par('bias_gamma_e')
            new_params['bias_prim'] = get_par('bias_prim')
            new_params['lambda_HeII'] = get_par('lambda_HeII')
            new_params['uv_shotnoise_amp'] = get_par('uv_shotnoise_amp')

        if opt['metals'] is not None:
            for name in opt['metals']:
                if opt['use_metal_bias_eta']:
                    new_params[f'bias_eta_{name}'] = get_par(
                        f'bias_eta_{name}')
                else:
                    new_params[f'bias_{name}'] = get_par(f'bias_{name}')
                new_params[f'beta_{name}'] = get_par(f'beta_{name}')
                new_params[f'alpha_{name}'] = get_par(f'alpha_{name}')
            if opt['single-metal-beta']:
                new_params['beta_metals'] = get_par('beta_metals')

        if opt['fullshape_smoothing'] is not None:
            if opt['fullshape_smoothing'] == 'exp':
                for par in ['par_exp_smooth', 'per_exp_smooth',
                            'par_sigma_smooth', 'per_sigma_smooth']:
                    new_params[par] = get_par(par)
            if opt['fullshape_smoothing'] == 'gauss_iso':
                new_params['par_sigma_smooth'] = get_par('par_sigma_smooth')
            if opt['fullshape_smoothing'] == 'gauss':
                for group in ['', '_QSO', '_LYA', '_metals']:
                    if f'par_sigma_smooth{group}' in parameters:
                        new_params[f'par_sigma_smooth{group}'] = get_par(
                            f'par_sigma_smooth{group}')
                        new_params[f'per_sigma_smooth{group}'] = get_par(
                            f'per_sigma_smooth{group}')

        if opt['mock-los-smoothing'] == 'amplitude':
            new_params['los_smooth_amp'] = get_par('los_smooth_amp')

        if opt['desi-instrumental-systematics']:
            new_params['desi_inst_sys_amp'] = get_par('desi_inst_sys_amp')

        for name, value in parameters.items():
            if 'BB' in name and name not in new_params:
                new_params[name] = value

        if opt.get('marginalize-small-scales', False):
            for name, value in parameters.items():
                if 'bias_xi' in name and name not in new_params:
                    new_params[name] = value

        self._parameters = new_params

    @staticmethod
    def get_lya_bias(z):
        """Default Lya bias (reference: build_config.py:898-913)."""
        return -0.1167 * ((1 + z) / (1 + 2.334)) ** 2.9

    @staticmethod
    def get_qso_bias(z):
        """Default QSO bias (reference: build_config.py:915-930)."""
        return 3.91 * ((1 + z) / (1 + 2.39)) ** 1.7133

    @staticmethod
    def get_growth_rate(z, Omega_m=0.3153):
        """Default growth rate (reference: build_config.py:932-948)."""
        omega_m_z = (Omega_m * (1 + z) ** 3
                     / (Omega_m * (1 + z) ** 3 + 1 - Omega_m))
        omega_lambda_z = 1 - omega_m_z
        return (omega_m_z ** 0.6
                + (omega_lambda_z / 70.) * (1 + omega_m_z / 2.))
