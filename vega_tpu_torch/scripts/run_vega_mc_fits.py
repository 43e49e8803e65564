#!/usr/bin/env python
"""Fit saved Monte-Carlo mocks on one GPU.

    python -m vega_tpu_torch.scripts.run_vega_mc_fits main.ini
        [--device cpu]

Counterpart of vega_tpu/scripts/run_vega_mc_fits.py: reads the MOCKS HDU
of the file `[control] mc_mocks` names (per-correlation columns, full
grid or masked, or one `global` column cut by `[control] slice_start1`
.. `slice_end2` and split back into the correlations), fits every mock
as one row of the batched Newton (parallel.MonteCarloEngine) and writes
monte_carlo.fits as run_vega_mc does. --n-devices takes 1 only.
"""

import argparse
import sys

import numpy as np


def read_mocks(vega, mock_path, slices):
    """{name: (n_mocks, n_masked)} from the MOCKS HDU of `mock_path`
    (vega_tpu/scripts/run_vega_mc_fits.py:45-78)."""
    from vega_tpu_torch.io.fits import read_fits
    from vega_tpu_torch.utils import find_file

    mocks_table = None
    for hdu in read_fits(find_file(mock_path)):
        if getattr(hdu, 'name', '').upper() == 'MOCKS':
            mocks_table = hdu
    if mocks_table is None:
        raise ValueError(f'No MOCKS HDU in the mock file {mock_path}')

    if 'global' in mocks_table.columns:
        global_mocks = np.atleast_2d(mocks_table['global'])
        if all(s is not None for s in slices):
            s1, e1, s2, e2 = slices
            global_mocks = np.concatenate(
                [global_mocks[:, s1:e1], global_mocks[:, s2:e2]], axis=1)
        mocks, offset = {}, 0
        for name in vega.corr_items:
            size = vega.data[name].data_size
            mocks[name] = global_mocks[:, offset:offset + size]
            offset += size
        return mocks
    mocks = {}
    for name in vega.corr_items:
        mock = np.atleast_2d(mocks_table[name])
        mask = vega.data[name].data_mask
        mocks[name] = mock[:, mask] if mock.shape[1] == mask.size else mock
    return mocks


def main(argv=None):
    pars = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Fit saved Monte-Carlo mocks in one batch on one '
                    'device.')
    pars.add_argument('config', type=str, help='Config file')
    pars.add_argument('--n-devices', type=int, default=None,
                      help='Cards to shard the mocks over (1 only)')
    pars.add_argument('--device', type=str, default='cuda',
                      help="Device the fits run on: 'cuda', 'cuda:N' or "
                           "'cpu'")
    args = pars.parse_args(argv)

    from vega_tpu_torch.parallel import MonteCarloEngine
    from vega_tpu_torch.scripts.run_vega_mc import check_devices, store_fits
    from vega_tpu_torch.vega_interface import VegaInterface
    check_devices(args.n_devices)

    print('Initializing vega_tpu_torch')
    vega = VegaInterface(args.config, device=args.device)
    control = vega.main_config['control']

    if not control.getboolean('use_distortion', True):
        # the models drop their distortion matrix
        # (vega_tpu/scripts/run_vega_mc_fits.py:32-36)
        for name in vega.corr_items:
            vega.data[name]._distortion_mat = None
            vega.models[name]._dist_mat = None

    if not control.getboolean('run_montecarlo', False) \
            or vega.mc_config is None:
        raise ValueError('Monte Carlo not requested. Add "run_montecarlo = '
                         'True" to the "[control]" section.')
    vega.monte_carlo = True

    slices = [control.getint(f'slice_{key}', None)
              for key in ('start1', 'end1', 'start2', 'end2')]
    mocks = read_mocks(vega, control.get('mc_mocks'), slices)
    results = MonteCarloEngine(vega).fit_mocks(mocks)
    store_fits(vega.analysis, results, mocks)
    vega.output.write_monte_carlo()
    return 0


if __name__ == '__main__':
    sys.exit(main())
