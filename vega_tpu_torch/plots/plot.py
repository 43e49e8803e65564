"""Plotting: wedge / shell compression panels for correlation data and
models.

A copy of vega_tpu/plots/plot.py, with the public building blocks of
the reference's plots/plot.py: `plot_data` (:191-262) / `plot_model`
(:263-338) as the primitives, `postprocess_wedge_plot` /
`postprocess_fig` (:339-402), the composed `plot_wedge` (:403-477) /
`plot_shells_panel` (:478-545) / `plot_shells_residuals` (:546-586), the
panel drivers `plot_1wedge` / `plot_2wedges` / `plot_4wedges`
(:587-745), `plot_4wedge_panel` (:747-813), `plot_4shells` (:814-890)
and `plot_sensitivity` (:892-1010). The weight-matrix machinery lives in
wedges.py / shell.py; everything here is host-side matplotlib, read off
an interface's `data` (data.Data: data_vec, cov_mat_org, the scale cuts
and coordinates).
"""

from __future__ import annotations

import numpy as np
import matplotlib.pyplot as plt

from .shell import Shell
from .utils import array_or_dict
from .wedges import Wedge


class VegaPlots:
    """Plotting module (reference: plots/plot.py:9-75 for init)."""

    def __init__(self, vega_data=None):
        self.cross_flag = {}
        self.data = {}
        self.cov_mat = {}
        self.rp_setup_model = {}
        self.rt_setup_model = {}
        self.r_setup_model = {}
        self.rp_setup_data = {}
        self.rt_setup_data = {}
        self.r_setup_data = {}
        self.has_data = False
        self.cuts = {}
        self.mask = {}
        self.fig = None

        if vega_data is not None:
            for name, data in vega_data.items():
                cross_flag = data.tracer1['type'] != data.tracer2['type']
                self.cross_flag[name] = cross_flag
                self.data[name] = data.data_vec
                if data.has_cov_mat_org:
                    self.cov_mat[name] = data.cov_mat_org

                (self.rp_setup_data[name], self.rt_setup_data[name],
                 self.r_setup_data[name]) = self.initialize_coordinates(
                    data.data_coordinates)
                self.cuts[name] = {'r_min': data.r_min_cut,
                                   'r_max': data.r_max_cut}
                self.mask[name] = \
                    data.dist_model_coordinates.get_mask_to_other(
                        data.data_coordinates)
                (self.rp_setup_model[name], self.rt_setup_model[name],
                 self.r_setup_model[name]) = self.initialize_coordinates(
                    data.model_coordinates)
            self.has_data = True

    @staticmethod
    def initialize_coordinates(coordinates):
        rp_setup = (coordinates.rp_min, coordinates.rp_max,
                    coordinates.rp_nbins)
        rt_setup = (0., coordinates.rt_max, coordinates.rt_nbins)
        return rp_setup, rt_setup, rt_setup

    # ------------------------------------------------------------------
    # Compression-object factories
    # ------------------------------------------------------------------
    def _stored_setups(self, corr_name, is_data):
        if is_data:
            return (self.rp_setup_data[corr_name],
                    self.rt_setup_data[corr_name],
                    self.r_setup_data[corr_name])
        return (self.rp_setup_model[corr_name],
                self.rt_setup_model[corr_name],
                self.r_setup_model[corr_name])

    def initialize_wedge(self, mu_bin, corr_name=None, is_data=False,
                         cross_flag=False, rp_setup=None, rt_setup=None,
                         r_setup=None, abs_mu=True, **kwargs):
        """Wedge compression object (reference: plots/plot.py:77-130)."""
        if corr_name is not None:
            rp, rt, r = self._stored_setups(corr_name, is_data)
            if self.cross_flag[corr_name] and abs_mu:
                r = (0, rp[1], rp[2] // 2)
        else:
            if rp_setup is not None:
                rp = rp_setup
            else:
                rp = (-200., 200., 100) if cross_flag else (0., 200., 50)
            rt = rt_setup if rt_setup is not None else (0., 200., 50)
            r = r_setup if r_setup is not None else (0., 200., 50)
            if cross_flag and abs_mu and r_setup is None:
                r = (0, rp[1], rp[2] // 2)
        return Wedge(rp=rp, rt=rt, r=r, mu=mu_bin, abs_mu=abs_mu)

    def initialize_shell(self, r_bin, corr_name=None, is_data=False,
                         cross_flag=False, rp_setup=None, rt_setup=None,
                         angle_var='theta', **kwargs):
        """Shell compression object (reference: plots/plot.py:131-190)."""
        if corr_name is not None:
            rp, rt, _ = self._stored_setups(corr_name, is_data)
        else:
            if rp_setup is not None:
                rp = rp_setup
            else:
                rp = (-200., 200., 100) if cross_flag else (0., 200., 50)
            rt = rt_setup if rt_setup is not None else (0., 200., 50)

        if angle_var == 'theta':
            angle_range = (0, np.pi) if cross_flag else (0, np.pi / 2)
        else:
            angle_range = (-1, 1) if cross_flag else (0, 1)

        # manually-tuned bin-count heuristic (reference: plot.py:184)
        binning_factor = np.mean(r_bin) * np.sqrt(r_bin[1] - r_bin[0]) * 3
        return Shell(r=r_bin, rp=rp, rt=rt, angle_var=angle_var,
                     angle_range=angle_range,
                     num_bins_fraction=binning_factor)

    # ------------------------------------------------------------------
    # Primitives
    # ------------------------------------------------------------------
    def plot_data(self, ax, x_bin, is_shell=False, data=None, cov_mat=None,
                  cross_flag=False, data_label=None, corr_name='lyaxlya',
                  data_fmt='o', data_color=None, scaling_power=2,
                  use_local_coordinates=True, alpha=1.0, **kwargs):
        """Compress and plot the data vector into one wedge/shell
        (reference: plots/plot.py:191-262). Returns (x, values, cov)."""
        init = self.initialize_shell if is_shell else self.initialize_wedge
        if use_local_coordinates and self.has_data:
            compressor = init(x_bin, corr_name, True, cross_flag, **kwargs)
        else:
            compressor = init(x_bin, cross_flag=cross_flag, **kwargs)

        if data is None:
            if corr_name not in self.data:
                raise ValueError(
                    f'Correlation {corr_name} not found in input data')
            data = self.data[corr_name]
        if cov_mat is None:
            if corr_name not in self.cov_mat:
                raise ValueError(
                    f'Correlation {corr_name} not found in input data')
            cov_mat = self.cov_mat[corr_name]

        x_grid, x_data, x_cov = compressor(
            np.asarray(array_or_dict(data, corr_name)),
            np.asarray(array_or_dict(cov_mat, corr_name)))

        yerr = np.sqrt(np.diag(x_cov))
        if is_shell:
            ax.errorbar(x_grid, x_data * 1e3, yerr=yerr * 1e3,
                        fmt=data_fmt, color=data_color, label=data_label,
                        alpha=alpha, capsize=2)
        else:
            scale = x_grid ** scaling_power
            ax.errorbar(x_grid, x_data * scale, yerr=yerr * scale,
                        fmt=data_fmt, color=data_color, label=data_label,
                        alpha=alpha)
        return x_grid, x_data, x_cov

    def plot_model(self, ax, x_bin, is_shell=False, model=None,
                   cov_mat=None, cross_flag=False, label=None,
                   corr_name='lyaxlya', model_ls='-', model_color=None,
                   scaling_power=2, use_local_coordinates=True, **kwargs):
        """Compress and plot one model vector (reference:
        plots/plot.py:263-338). Model vectors on the (distorted) model
        grid are masked onto the data grid when the stored mask matches;
        with a covariance available the covariance-weighted compression
        is used. Returns (x, values)."""
        if cov_mat is None and corr_name in self.cov_mat:
            cov_mat = self.cov_mat[corr_name]

        model_vec = np.array(array_or_dict(model, corr_name))
        masked_model = None
        if cov_mat is not None and corr_name in self.mask:
            if len(self.mask[corr_name]) == len(model_vec):
                masked_model = model_vec[self.mask[corr_name]]
                if len(masked_model) != len(self.data[corr_name]):
                    raise ValueError(
                        'Masked model array does not match data array.')

        init = self.initialize_shell if is_shell else self.initialize_wedge
        if masked_model is not None:
            compressor = init(x_bin, corr_name, True, cross_flag, **kwargs)
        elif use_local_coordinates and self.has_data:
            compressor = init(x_bin, corr_name, False, cross_flag,
                              **kwargs)
        else:
            compressor = init(x_bin, cross_flag=cross_flag, **kwargs)

        covariance = (None if cov_mat is None
                      else np.asarray(array_or_dict(cov_mat, corr_name)))
        if covariance is None or \
                compressor.weights.shape[1] != covariance.shape[0]:
            x_grid, x_model = compressor(model_vec)
        else:
            to_compress = (masked_model if masked_model is not None
                           else model_vec)
            x_grid, x_model, _ = compressor(to_compress, covariance)

        if is_shell:
            ax.plot(x_grid, x_model * 1e3, ls=model_ls, color=model_color,
                    label=label)
        else:
            ax.plot(x_grid, x_model * x_grid ** scaling_power, ls=model_ls,
                    color=model_color, label=label)
        return x_grid, x_model

    # ------------------------------------------------------------------
    # Postprocessing
    # ------------------------------------------------------------------
    def postprocess_wedge_plot(self, ax, mu_bin=None, xlim=(0, 180),
                               ylim=None, no_legend=False, title='mu_bin',
                               legend_loc='best', legend_ncol=1, **kwargs):
        """Labels / limits / legend / grid for one wedge axis
        (reference: plots/plot.py:339-373)."""
        if not kwargs.get('no_ylabel', False):
            ax.set_ylabel(r'$r^2\xi(r)$')
        if not kwargs.get('no_xlabel', False):
            ax.set_xlabel(r'$r~[\mathrm{Mpc/h}]$')
        if title == 'mu_bin' and mu_bin is not None:
            ax.set_title(rf'${mu_bin[0]}<\mu<{mu_bin[1]}$')
        elif title is not None and title != 'mu_bin':
            ax.set_title(title)
        if xlim is not None:
            ax.set_xlim(*xlim)
        if ylim is not None:
            ax.set_ylim(*ylim)
        if not no_legend:
            ax.legend(loc=legend_loc, ncol=legend_ncol)
        ax.grid()

    @staticmethod
    def postprocess_fig(fig, xlim=(0, 180), ylim=None):
        """Grid + shared limits for every axis of a figure (reference:
        plots/plot.py:375-402). ylim may be one (ymin, ymax) pair or one
        row per axis."""
        for ax in fig.axes:
            ax.grid()
            ax.set_xlim(*xlim)
        if ylim is None:
            return
        ylim = np.array(ylim)
        if ylim.ndim == 1:
            for ax in fig.axes:
                ax.set_ylim(*ylim)
        elif ylim.ndim == 2:
            for ax, (ymin, ymax) in zip(fig.axes, ylim):
                ax.set_ylim(ymin, ymax)
        else:
            raise ValueError(
                f'ylim variable has unsupported ndim {ylim.ndim}, '
                'only 1D and 2D arrays/lists/tuples allowed')

    # ------------------------------------------------------------------
    # Composed plots
    # ------------------------------------------------------------------
    def plot_wedge(self, ax, mu_bin, models=None, cov_mat=None, labels=None,
                   data=None, cross_flag=False, corr_name='lyaxlya',
                   models_only=False, data_only=False, data_label=None,
                   no_postprocess=False, model_colors=None, models_ls=None,
                   **kwargs):
        """Data +/- models in one mu wedge (reference:
        plots/plot.py:403-477). Returns (data_wedge, last_model_wedge)."""
        data_wedge = None
        if not models_only:
            data_wedge = self.plot_data(
                ax, mu_bin, data=data, cov_mat=cov_mat,
                cross_flag=cross_flag, data_label=data_label,
                corr_name=corr_name, **kwargs)

        model_wedge = None
        if not data_only and models is not None:
            for i, model in enumerate(models):
                model_wedge = self.plot_model(
                    ax, mu_bin, model=model, cov_mat=cov_mat,
                    cross_flag=cross_flag, corr_name=corr_name,
                    label=(labels[i] if labels is not None
                           and i < len(labels) else None),
                    model_ls=(models_ls[i] if models_ls is not None
                              else '-'),
                    model_color=(model_colors[i]
                                 if model_colors is not None else None),
                    **kwargs)

        if not no_postprocess:
            self.postprocess_wedge_plot(ax, mu_bin, **kwargs)
        return data_wedge, model_wedge

    def plot_shells_panel(self, ax, r_bins, model=None, cov_mat=None,
                          labels=None, data=None, cross_flag=False,
                          corr_name='lyaxlya', models_only=False,
                          data_fmts=None, colors=None, data_only=False,
                          no_postprocess=False, **kwargs):
        """Data +/- model in several fixed-r shells on one axis
        (reference: plots/plot.py:478-545). Returns
        (data_shells, model_shells) lists of compression outputs."""
        data_shells, model_shells = [], []
        for i, r_bin in enumerate(r_bins):
            fmt = '.' if data_fmts is None else data_fmts[i]
            color = None if colors is None else colors[i]
            if labels is None:
                label = rf'$r \in [{r_bin[0]:.0f}, {r_bin[1]:.0f}]$ Mpc/h'
            else:
                label = labels[i] if i < len(labels) else None

            if not models_only:
                data_shells.append(self.plot_data(
                    ax, r_bin, is_shell=True, data=data, cov_mat=cov_mat,
                    cross_flag=cross_flag, data_label=label,
                    corr_name=corr_name, data_fmt=fmt, data_color=color,
                    **kwargs))
            if not data_only:
                model_shells.append(self.plot_model(
                    ax, r_bin, is_shell=True, model=model, cov_mat=cov_mat,
                    cross_flag=cross_flag, corr_name=corr_name,
                    model_color=color, **kwargs))
        return data_shells, model_shells

    def plot_shells_residuals(self, ax, data_shells, model_shells,
                              data_fmts=None, colors=None, alpha=1.0,
                              var_latex=r'\theta', set_ylabel=True,
                              **kwargs):
        """Normalized (data - model)/sigma residual panel under a shell
        plot (reference: plots/plot.py:546-586)."""
        assert len(data_shells) == len(model_shells), (
            'data_shells and model_shells must have the same number of '
            f'entries, got {len(data_shells)} and {len(model_shells)}')

        max_residual = 0.0
        for i, (data_shell, model_shell) in enumerate(
                zip(data_shells, model_shells)):
            x_grid, x_data, x_cov = data_shell
            residuals = (x_data - model_shell[1]) / np.sqrt(np.diag(x_cov))
            max_residual = max(max_residual, np.max(np.abs(residuals)))
            ax.errorbar(x_grid, residuals, yerr=np.ones_like(residuals),
                        fmt='.' if data_fmts is None else data_fmts[i],
                        color=None if colors is None else colors[i],
                        alpha=alpha, capsize=2)

        if set_ylabel:
            ax.set_ylabel(r'$\Delta\xi(' + var_latex
                          + r')/\sigma_{\xi}$')
        ax.set_xlabel(r'$\theta$ [deg]' if 'theta' in var_latex
                      else f'${var_latex}$')
        ax.axhline(0, c='k')
        lim = 4 if max_residual < 3 else max_residual + 1
        ax.set_ylim(-lim, lim)

    # ------------------------------------------------------------------
    # Panel drivers
    # ------------------------------------------------------------------
    def _wedge_limits(self, mu_bins):
        """Edge tuple -> wedge (mu_min, mu_max) pairs, highest-mu panel
        first (the reference's panel ordering, plot.py:670-672)."""
        edges = np.flip(np.array(mu_bins))
        return list(zip(edges[1:], edges[:-1]))

    def plot_1wedge(self, models=None, cov_mat=None, labels=None, data=None,
                    cross_flag=False, corr_name='lyaxlya', models_only=False,
                    data_only=False, data_label=None, fig=None, **kwargs):
        """One wedge over the full mu range (reference:
        plots/plot.py:587-625)."""
        if not kwargs.get('no_font', False):
            plt.rcParams['font.size'] = 14
        if fig is None:
            fig, ax = plt.subplots(1, figsize=(10, 6))
        else:
            ax = fig.axes[0]
        self.plot_wedge(ax, (0, 1), models=models, cov_mat=cov_mat,
                        labels=labels, data=data, cross_flag=cross_flag,
                        corr_name=corr_name, models_only=models_only,
                        data_only=data_only, data_label=data_label,
                        **kwargs)
        self.fig = fig
        return fig

    def plot_2wedges(self, mu_bins=(0, 0.5, 1), models=None, cov_mat=None,
                     labels=None, data=None, cross_flag=False,
                     corr_name='lyaxlya', models_only=False, data_only=False,
                     data_label=None, vertical_plots=False, fig=None,
                     **kwargs):
        """Two wedges from three mu edges (reference:
        plots/plot.py:627-679)."""
        assert len(mu_bins) == 3
        if not kwargs.get('no_font', False):
            plt.rcParams['font.size'] = 14
        if fig is None:
            shape = (2, 1) if vertical_plots else (1, 2)
            size = (10, 12) if vertical_plots else (18, 6)
            fig, axs = plt.subplots(*shape, figsize=size)
        else:
            axs = np.array(fig.axes)
        for ax, mu_bin in zip(np.ravel(axs), self._wedge_limits(mu_bins)):
            self.plot_wedge(ax, mu_bin, models=models, cov_mat=cov_mat,
                            labels=labels, data=data, cross_flag=cross_flag,
                            corr_name=corr_name, models_only=models_only,
                            data_only=data_only, data_label=data_label,
                            **kwargs)
        self.fig = fig
        return fig

    def _shade_cut_regions(self, ax, corr_name, span=(-100, 100)):
        """Gray out the scale-cut regions (reference: plot.py:734-741)."""
        xmin, xmax = ax.get_xlim()
        ymin, ymax = ax.get_ylim()
        ax.fill_betweenx(span, xmin, self.cuts[corr_name]['r_min'],
                         color='gray', alpha=0.7)
        ax.fill_betweenx(span, self.cuts[corr_name]['r_max'], xmax,
                         color='gray', alpha=0.7)
        ax.set_ylim(ymin, ymax)
        ax.set_xlim(xmin, xmax)

    def plot_4wedges(self, mu_bins=(0, 0.5, 0.8, 0.95, 1), models=None,
                     cov_mat=None, labels=None, data=None, cross_flag=False,
                     corr_name='lyaxlya', models_only=False, data_only=False,
                     data_label=None, figsize=(14, 8), mu_bin_labels=False,
                     fig=None, **kwargs):
        """Four wedges from five mu edges on a 2x2 panel (reference:
        plots/plot.py:681-745)."""
        assert len(mu_bins) == 5
        if not kwargs.get('no_font', False):
            plt.rcParams['font.size'] = 14
        if fig is None:
            fig, axs = plt.subplots(2, 2, figsize=figsize)
        else:
            axs = np.array(fig.axes)

        no_xlabel = [True, True, False, False]
        no_ylabel = [False, True, False, True]
        for ax, mu_bin, no_xl, no_yl in zip(
                np.ravel(axs), self._wedge_limits(mu_bins), no_xlabel,
                no_ylabel):
            if mu_bin_labels:
                data_label = rf'${mu_bin[0]}<|\mu|<{mu_bin[1]}$'
            self.plot_wedge(ax, mu_bin, models=models, cov_mat=cov_mat,
                            labels=labels, data=data, cross_flag=cross_flag,
                            corr_name=corr_name, models_only=models_only,
                            data_only=data_only, data_label=data_label,
                            no_xlabel=no_xl, no_ylabel=no_yl, **kwargs)
            if self.has_data:
                self._shade_cut_regions(ax, corr_name)

        plt.tight_layout()
        self.fig = fig
        return fig

    def plot_4wedge_panel(self, mu_bins=(0, 0.5, 0.8, 0.95, 1), model=None,
                          cov_mat=None, data=None, cross_flag=False,
                          corr_name='lyaxlya', colors=None, data_only=False,
                          title=None, figsize=(8, 6), fig=None, **kwargs):
        """All four wedges overlaid on ONE axis, color-coded by mu range
        (reference: plots/plot.py:747-813)."""
        assert len(mu_bins) == 5
        if not kwargs.get('no_font', False):
            plt.rcParams['font.size'] = 14
        if fig is None:
            fig, ax = plt.subplots(1, figsize=figsize)
        else:
            ax = fig.axes[0]

        if colors is None:
            cmap = plt.get_cmap('seismic')
            colors = cmap((0.03, 0.25, 0.75, 1))

        for mu_bin, color in zip(self._wedge_limits(mu_bins), colors):
            label = (f'{mu_bin[0]:.2f} < ' + r'$|\mu|$'
                     + f' < {mu_bin[1]:.2f}')
            self.plot_wedge(ax, mu_bin, models=[model], cov_mat=cov_mat,
                            labels=[label], model_colors=[color],
                            data_color=color, data=data,
                            cross_flag=cross_flag, corr_name=corr_name,
                            data_only=data_only,
                            data_label=label if data_only else None,
                            no_postprocess=True, **kwargs)

        xmin, xmax = ax.get_xlim()
        self.postprocess_wedge_plot(ax, title=title, **kwargs)
        if self.has_data:
            ymin, ymax = ax.get_ylim()
            self._shade_cut_regions(ax, corr_name, span=(ymin, ymax))
        ax.set_xlim(xmin, xmax)
        self.fig = fig
        return fig

    def plot_4shells(self, model=None, angle_var='theta', r_bins=None,
                     corr_name='lyaxlya', var_latex=r'\theta', **kwargs):
        """Four fixed-r shells (2x2 with residual strips; reference:
        plots/plot.py:814-890)."""
        if r_bins is None:
            rmin = self.cuts[corr_name]['r_min']
            rmax = self.cuts[corr_name]['r_max']
            r_bins = np.logspace(np.log10(rmin), np.log10(rmax), 5)
            r_bins[1:-1] = np.round(r_bins[1:-1], -1)
        else:
            assert len(r_bins) == 5, \
                'plot_4shells works with exactly 4 shells (5 bin edges)'

        plt.rcParams['font.size'] = 16
        fig, axs = plt.subplots(2, 2, figsize=(16, 8), sharex=True,
                                height_ratios=(4, 1),
                                gridspec_kw={'hspace': 0})
        r_zip = list(zip(r_bins[:-1], r_bins[1:]))
        cmap = plt.get_cmap('seismic')
        colors = cmap((0.25, 0.75, 0.03, 1.0))
        fmts = ['d', '.', 'd', '.']
        cross = self.cross_flag.get(corr_name, 'qso' in corr_name)

        for col, (shells, cols, fs) in enumerate(
                [(r_zip[:2], colors[:2], fmts[:2]),
                 (r_zip[2:], colors[2:], fmts[2:])]):
            data_shells, model_shells = self.plot_shells_panel(
                axs[0, col], shells, model=model, cross_flag=cross,
                corr_name=corr_name, data_fmts=fs, colors=cols,
                angle_var=angle_var, **kwargs)
            self.plot_shells_residuals(
                axs[1, col], data_shells, model_shells, data_fmts=fs,
                colors=cols, set_ylabel=(col == 0), var_latex=var_latex)

        axs[0, 0].set_ylabel(r'$10^3\xi(' + var_latex + r')$')
        axs[0, 0].legend()
        axs[0, 1].legend()
        ticks = ([0, 30, 60, 90, 120, 150, 180] if cross
                 else [0, 30, 60, 90])
        if angle_var == 'theta':
            axs[1, 0].set_xticks(ticks)
            axs[1, 1].set_xticks(ticks)
        self.fig = fig
        return fig

    # ------------------------------------------------------------------
    def plot_sensitivity(self, sensitivity, corr_name, param,
                         idistort=0, **kwargs):
        """Heatmap of the Fisher information over the (rp, rt) grid
        (reference: plots/plot.py:892-1010)."""
        rp = self.rp_setup_model[corr_name]
        rt = self.rt_setup_model[corr_name]
        fisher = sensitivity['fisher'][corr_name]
        key = (param, param) if (param, param) in fisher else param
        grid = np.asarray(fisher[key])[idistort].reshape(rp[2], rt[2])

        fig, ax = plt.subplots(figsize=(8, 6))
        extent = [rt[0], rt[1], rp[0], rp[1]]
        im = ax.imshow(grid, origin='lower', extent=extent, aspect='auto',
                       cmap='RdBu_r')
        fig.colorbar(im, ax=ax, label='Fisher information')
        ax.set_xlabel(r'$r_\perp~[\mathrm{Mpc/h}]$')
        ax.set_ylabel(r'$r_\parallel~[\mathrm{Mpc/h}]$')
        ax.set_title(f'{corr_name}: {param}')
        self.fig = fig
        return fig
