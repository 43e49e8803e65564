#!/usr/bin/env python
"""CLI config builder (counterpart of the reference's bin/make_configs.py).

    vega_make_configs_torch --fit-name lyaxlya_lyaxqso --corr-paths cf.fits \
        xcf.fits --out-path configs --sample-params ap at bias_LYA

A copy of vega_tpu/scripts/make_configs.py on the port's BuildConfig
(vega_tpu_torch/build_config.py): the same arguments write the same
files, apart from the date and git-hash lines."""

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Create config files for vega_tpu_torch.')

    parser.add_argument('--fit-name', type=str, required=True,
                        help=('Name of the fit: correlations with tracers '
                              'separated by "x" and components separated by '
                              'an underscore (e.g. lyaxlya_lyaxqso).'))
    parser.add_argument('--corr-paths', type=str, nargs='*', required=True,
                        help='Paths to the measured correlation files.')
    parser.add_argument('--out-path', type=str, required=True,
                        help='Directory to write the config files into')
    parser.add_argument('--sample-params', type=str, nargs='*',
                        required=True, help='Parameters to sample/fit.')
    parser.add_argument('--zeff', type=float, default=None)
    parser.add_argument('--sampler', action='store_true',
                        help='Enable the sampler.')
    parser.add_argument('--rmin-values', type=float, nargs='*',
                        default=[40.])
    parser.add_argument('--rmax-values', type=float, nargs='*',
                        default=[160.])
    parser.add_argument('--scale-params', type=str, default='ap_at')
    parser.add_argument('--metals', type=str, nargs='*', default=None)
    parser.add_argument('--metal-paths', type=str, nargs='*', default=None)
    parser.add_argument('--template', type=str,
                        default='PlanckDR16/PlanckDR16.fits')
    parser.add_argument('--small-scale-nl', action='store_true')
    parser.add_argument('--bao-broadening', action='store_true')
    parser.add_argument('--uv-background', action='store_true')
    parser.add_argument('--velocity-dispersion', type=str, default=None)
    parser.add_argument('--radiation-effects', action='store_true')
    parser.add_argument('--hcd-model', type=str, default=None)
    parser.add_argument('--fvoigt-model', type=str, default='exp')
    parser.add_argument('--fullshape-smoothing', type=str, default=None)
    parser.add_argument('--name-extension', type=str, default=None)
    args = parser.parse_args(argv)

    from vega_tpu_torch.build_config import BuildConfig

    options = {
        'scale_params': args.scale_params,
        'template': args.template,
        'small_scale_nl': args.small_scale_nl,
        'bao_broadening': args.bao_broadening,
        'UVB-fluctuations': args.uv_background,
        'velocity_dispersion': args.velocity_dispersion,
        'radiation_effects': args.radiation_effects,
        'hcd_model': args.hcd_model,
        'fvoigt_model': args.fvoigt_model,
        'fullshape_smoothing': args.fullshape_smoothing,
        'metals': args.metals,
    }

    components = args.fit_name.split('_')
    if len(args.corr_paths) != len(components):
        raise ValueError('Number of correlation paths must match the number '
                         'of fit components.')

    rmins = (args.rmin_values if len(args.rmin_values) == len(components)
             else args.rmin_values * len(components))
    rmaxs = (args.rmax_values if len(args.rmax_values) == len(components)
             else args.rmax_values * len(components))

    correlations = {}
    for i, name in enumerate(components):
        corr = {'corr_path': args.corr_paths[i],
                'r-min': rmins[i], 'r-max': rmaxs[i]}
        if args.metal_paths is not None:
            corr['metal_path'] = args.metal_paths[min(
                i, len(args.metal_paths) - 1)]
        correlations[name] = corr

    fit_info = {
        'fitter': True,
        'run_sampler': args.sampler,
        'zeff': args.zeff,
        'sample_params': args.sample_params,
        'bias_beta_config': {},
    }

    builder = BuildConfig(options, overwrite=True)
    main_path = builder.build(correlations, args.fit_name, fit_info,
                              args.out_path,
                              name_extension=args.name_extension)
    print(f'Wrote main config to {main_path}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
