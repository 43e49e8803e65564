"""Standalone plotting helpers: quick wedge panels without a VegaPlots
instance. A copy of vega_tpu/plots/utils.py."""

from __future__ import annotations

import numpy as np
import matplotlib.pyplot as plt

from .shell import Shell
from .wedges import Wedge


def array_or_dict(input_obj, corr_name='lyalya_lyalya'):
    """Return input_obj directly if it is an array, or look up corr_name
    when it is a dict (reference: plots/utils.py:8-26)."""
    if isinstance(input_obj, dict):
        return input_obj[corr_name]
    return input_obj


def plot_wedges(models, covariance, multi_model=False, labels=None,
                data=None, cross=False):
    """Four mu-wedge panels of model(s) +/- data
    (reference: plots/utils.py:29-152)."""
    plt.rcParams['font.size'] = 14
    fig, axs = plt.subplots(2, 2, figsize=(18, 12))
    axs = np.array(axs).reshape(-1)
    mus = np.array([0., 0.5, 0.8, 0.95, 1.])

    if not multi_model:
        models = [models]
        labels = [labels] if labels is not None else [None]
    if labels is None:
        labels = [None] * len(models)

    for ax, mu in zip(axs, zip(mus[:-1], mus[1:])):
        if not cross:
            wedge_obj = Wedge(mu=mu, rp=(0., 200., 50), rt=(0., 200., 50),
                              r=(0., 200., 50), abs_mu=True)
        else:
            wedge_obj = Wedge(mu=mu, rp=(-200., 200., 100),
                              rt=(0., 200., 50), r=(0., 200., 50),
                              abs_mu=True)

        if data is not None:
            r_d, wedge_d, cov_d = wedge_obj(np.asarray(data),
                                            np.asarray(covariance))
            ax.errorbar(r_d, wedge_d * r_d ** 2,
                        yerr=np.sqrt(np.diag(cov_d)) * r_d ** 2,
                        fmt='o', ms=3, color='k', label='data')

        for model, label in zip(models, labels):
            model = np.asarray(model)
            r_m, wedge_m, cov_m = wedge_obj(model, np.asarray(covariance))
            ax.plot(r_m, wedge_m * r_m ** 2, label=label)

        ax.set_title(rf'${mu[0]} < |\mu| < {mu[1]}$')
        ax.set_xlabel(r'$r~[\mathrm{Mpc/h}]$')
        ax.set_ylabel(r'$r^2 \xi(r)$')
        if any(lab is not None for lab in labels) or data is not None:
            ax.legend()
    fig.tight_layout()
    return fig


def plot_shells(vega, model, angle_var='theta', rs=(30, 40, 50, 60, 70),
                corr='lyaxlya'):
    """Four fixed-r shell panels of data +/- model with pull rows
    (reference: plots/utils.py:83-152). `vega` is a VegaInterface,
    `model` a dict of per-correlation model vectors on the distorted
    model grid (e.g. from compute_model)."""
    cross = 'qso' in corr
    if angle_var == 'theta':
        angle_range = (0, np.pi) if cross else (0, np.pi / 2)
    else:
        angle_range = (-1, 1) if cross else (0, 1)

    corr_item = vega.corr_items[corr]
    data_obj = vega.data[corr]
    mask = corr_item.dist_model_coordinates.get_mask_to_other(
        corr_item.data_coordinates)
    model_vec = np.asarray(model[corr])[mask]
    data_vec = np.asarray(data_obj.data_vec)
    cov = np.asarray(data_obj.cov_mat)

    plt.rcParams['font.size'] = 16
    fig, axs = plt.subplots(2, 2, figsize=(16, 8), sharex=True,
                            height_ratios=(4, 1))
    cmap = plt.get_cmap('seismic')
    colors = cmap((0.25, 0.75, 0.03, 1.0))
    fmts = ['d', '.', 'd', '.']
    var_latex = {'mu': r'\mu', 'mu2': r'\mu^2'}.get(angle_var, r'\theta')

    for i, r_pair in enumerate(zip(rs[:-1], rs[1:])):
        ax_top, ax_pull = axs[0, i // 2], axs[1, i // 2]
        factor = np.mean(r_pair) * np.sqrt(r_pair[1] - r_pair[0]) * 3
        rp_lims = (-200, 200, 100) if cross else (0, 200, 50)
        shell = Shell(r=r_pair, rp=rp_lims, rt=(0, 200, 50),
                      num_bins_fraction=factor, abs_mu=not cross,
                      angle_var=angle_var, angle_range=angle_range)

        ang_d, shell_d, cov_d = shell(data_vec, covariance=cov)
        sig_d = np.sqrt(cov_d.diagonal())
        label = r"$r \in [{}, {}]$ Mpc/h".format(*r_pair)
        ax_top.errorbar(ang_d, shell_d * 1e3, yerr=sig_d * 1e3,
                        fmt=fmts[i], c=colors[i], capsize=2, label=label)

        ang_m, shell_m, _ = shell(model_vec, covariance=cov)
        ax_top.plot(ang_m, shell_m * 1e3, '-', c=colors[i])
        ax_pull.errorbar(ang_d, (shell_d - shell_m) / sig_d,
                         yerr=np.ones_like(shell_m), fmt=fmts[i],
                         c=colors[i], capsize=2, label=label)

        ax_top.set_ylabel(r"$10^3\xi(" + var_latex + r")$")
        ax_top.legend(loc='upper center' if cross else 'lower left')
        ax_pull.set_ylabel(r"$\Delta\xi(" + var_latex + r")/\sigma_{\xi}$")
        ax_pull.set_xlabel(f"${var_latex}$")
        ax_pull.axhline(0, c='k')
        ax_pull.set_ylim(-4, 4)
        if angle_var == 'theta':
            ax_top.xaxis.set_inverted(True)
            ax_pull.xaxis.set_inverted(True)

    for ax in axs.flatten():
        ax.grid()
    plt.tight_layout()
    return fig
