"""Tutorial 3 — Wedges, shells and plotting, with the PyTorch port
(vega_tpu_torch) on the GPU.

Counterpart of examples/tutorials/03_plots.py: mu-wedge compression of
the 2D correlation (with covariance propagation) and the VegaPlots panel
helpers. The wedges are numpy; the figures need matplotlib, and where it
is not installed they are skipped with a printed line.

Run:  python 03_plots.py [--device cpu] [--size tiny]
      (writes PNGs next to the data)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse        # noqa: E402
import importlib.util  # noqa: E402
import tempfile        # noqa: E402

from vega_tpu_torch.plots.wedges import Wedge                # noqa: E402
from vega_tpu_torch.testing import make_synthetic_dataset   # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface     # noqa: E402


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    pars.add_argument('--size', default='full', choices=('full', 'tiny'),
                      help='size of the synthetic dataset')
    args = pars.parse_args(argv)

    workdir = Path(tempfile.mkdtemp(prefix='vega_tutorial_'))
    vega = VegaInterface(make_synthetic_dataset(workdir, cross=False,
                                                size=args.size,
                                                device=args.device),
                         device=args.device)
    vega.minimize()
    model = vega.compute_model(vega.bestfit.values, run_init=False)

    # --- Low-level: one mu-wedge as a weight matrix --------------------
    # (the data's rp / rt grid: 50 x 50 bins over [0, 200]; the tiny
    # dataset's 10 x 10 bins of 20 Mpc/h take r bins from 0)
    data = vega.data['lyaxlya']
    n_bins, r_bins = (10, (0., 180., 9)) if args.size == 'tiny' else (
        50, (10., 180., 43))
    wedge = Wedge(mu=(0.5, 1.0), rp=(0., 200., n_bins),
                  rt=(0., 200., n_bins), r=r_bins)
    r, xi_w, cov_w = wedge(data.data_vec, data.cov_mat)
    r_m, xi_m, _ = wedge(model['lyaxlya'], data.cov_mat)
    print(f'wedge mu in (0.5, 1): {r.size} r bins, data r^2 xi mean '
          f'{(xi_w * r ** 2).mean():.4e}, model {(xi_m * r_m ** 2).mean():.4e}')
    out = {'wedge_data_mean': float((xi_w * r ** 2).mean()),
           'wedge_model_mean': float((xi_m * r_m ** 2).mean()),
           'wedge_sigma_mean': float((cov_w.diagonal() ** 0.5).mean())}

    if importlib.util.find_spec('matplotlib') is None:
        print('matplotlib is not installed: the figures are skipped')
        return out
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.errorbar(r, xi_w * r ** 2, yerr=r ** 2 * cov_w.diagonal() ** 0.5,
                fmt='.', label='data')
    ax.plot(r_m, xi_m * r_m ** 2, label='best-fit model')
    ax.set_xlabel(r'$r\,[h^{-1}\,{\rm Mpc}]$')
    ax.set_ylabel(r'$r^2 \xi(r)$')
    ax.legend()
    fig.savefig(workdir / 'wedge.png', dpi=120)
    print(f'wrote {workdir / "wedge.png"}')

    # --- High-level: VegaPlots panels ----------------------------------
    plots = vega.plots                        # built from the fit data
    plots.plot_4wedges(models=[model['lyaxlya']], corr_name='lyaxlya',
                       labels=['best fit'])
    plt.savefig(workdir / 'four_wedges.png', dpi=120)
    print(f'wrote {workdir / "four_wedges.png"}')
    return out


if __name__ == '__main__':
    main()
