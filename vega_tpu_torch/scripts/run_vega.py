#!/usr/bin/env python
"""Fit a configuration, write the results and draw the plots.

    python -m vega_tpu_torch.scripts.run_vega main.ini [--device cpu]

Counterpart of vega_tpu/scripts/run_vega.py:13-79, in two steps:
`fit_and_write` (the interface on the device, the card unless --device
says otherwise: an optional Monte-Carlo mock, the fit, an optional chi^2
scan, `<[output] filename>.fits` with the components' HDUs when [output]
asks for them) and `write_plots` (the wedge and shell plots of each
correlation beside it, `<filename>_<name>_wedges.png` / `_shells.png`).
`run_vega` runs both, the plots only where matplotlib is installed: the
fit and its file need no matplotlib.
"""

import argparse
import importlib.util
import sys


def fit_and_write(config_path, device='cuda'):
    """Fit the configuration and write its results file
    (vega_tpu/scripts/run_vega.py:15-43); returns the interface."""
    from vega_tpu_torch.vega_interface import VegaInterface

    vega = VegaInterface(config_path, device=device)

    _ = vega.compute_model(run_init=False)

    run_montecarlo = vega.main_config['control'].getboolean(
        'run_montecarlo', False) if 'control' in vega.main_config else False
    if run_montecarlo and vega.mc_config is not None:
        _ = vega.initialize_monte_carlo()
    elif run_montecarlo:
        raise ValueError('You asked to run over a Monte Carlo simulation, '
                         'but no "[monte carlo]" section provided.')

    vega.minimize()

    scan_results = None
    if 'chi2 scan' in vega.main_config:
        scan_results = vega.analysis.chi2_scan()

    if vega.minimizer is not None:
        for par, val in vega.bestfit.values.items():
            vega.params[par] = val

    vega.output.write_results(
        vega.bestfit_model, vega.params, vega.minimizer,
        vega.bestfit_corr_stats, scan_results, vega.models)
    return vega


def write_plots(vega):
    """The best fit's four wedges and four shells of each correlation,
    as PNG files beside the results (vega_tpu/scripts/run_vega.py:45-77)."""
    import matplotlib

    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    num_pars = len(vega.sample_params['limits'])
    out_base = vega.output.outfile
    if out_base.endswith('.fits'):
        out_base = out_base[:-5]
    for name in vega.plots.data:
        legend = (f'Correlation: {name}, Total '
                  r'$\chi^2_\mathrm{best}/(N_\mathrm{data}-N_\mathrm{pars})$'
                  f': {vega.chisq:.1f}/({vega.total_data_size}-{num_pars}) '
                  f'= {vega.reduced_chisq:.3f}, PTE={vega.p_value:.2f}')
        if not vega.bestfit.fmin.is_valid:
            legend = 'Invalid fit! Disregard these results.'

        vega.plots.plot_4wedges(
            models=[vega.bestfit_model[name]], corr_name=name,
            mu_bin_labels=True, model_colors=['r'])
        vega.plots.fig.suptitle(legend, fontsize=14, y=1.03)
        vega.plots.fig.savefig(
            f'{out_base}_{name}_wedges.png', dpi='figure',
            bbox_inches='tight', facecolor='white')
        plt.close(vega.plots.fig)

        vega.plots.plot_4shells(model=vega.bestfit_model[name],
                                corr_name=name)
        vega.plots.fig.suptitle(legend, fontsize=14, y=0.95)
        vega.plots.fig.savefig(
            f'{out_base}_{name}_shells.png', dpi='figure',
            bbox_inches='tight', facecolor='white')
        plt.close(vega.plots.fig)


def run_vega(config_path, device='cuda'):
    """Run a complete fit: `fit_and_write`, then `write_plots` where
    matplotlib is installed; returns the interface."""
    vega = fit_and_write(config_path, device)
    if importlib.util.find_spec('matplotlib') is None:
        print('matplotlib is not installed: no plots')
    else:
        write_plots(vega)
    return vega


def main(argv=None):
    """Console entry: run_vega <main.ini> [--device ...]."""
    parser = argparse.ArgumentParser(
        description='Run a vega_tpu_torch fit')
    parser.add_argument('config', type=str, help='path to main.ini')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Device the fit runs on: 'cuda', 'cuda:N' or "
                             "'cpu'")
    args = parser.parse_args(argv)
    run_vega(args.config, args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
