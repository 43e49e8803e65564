"""The JAX package's (vega_tpu) side of a synthetic dataset with metals.

vega_tpu.testing.make_synthetic_dataset has no metals option: its DR16
example writes the metal files and the [metals] sections by hand
(examples/eBOSS_DR16/run_synthetic.py:106-125). `make_jax_metal_dataset`
does the same with vega_tpu's own functions, in the order of
vega_tpu_torch.testing.make_synthetic_dataset(..., metals=...), so the
two packages' files from the same arguments can be held against each
other, and vega_tpu can be run on the configuration the port runs
(tests/test_torch_metals.py, tests/tools/make_torch_port_dr16_goldens.py).
With `new_metals=True` it writes, as the port's function does, the
stacked-delta weights files (the port's `new_metals_weights`, written
with vega_tpu's write_fits), the new-metals lines of each ini, and the
data files with OMEGAM in their headers (vega_tpu's
_write_correlation_data has no such option: the header key is added by
rewriting the file); `global_cov=True` the joint covariance, through
vega_tpu's own make_synthetic_dataset code (tests/test_torch_desi.py,
tests/tools/make_torch_port_desi_goldens.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _with_omega_m(path, omega_m):
    """Rewrite a correlation FITS file written by vega_tpu with OMEGAM
    added to its first table's header."""
    from vega_tpu.io.fits import read_fits, write_fits
    hdul = read_fits(path)
    hdus = []
    for i, hdu in enumerate(hdul[1:]):
        header = {k: v for k, v in hdu.header.items()
                  if k in ('RPMIN', 'RPMAX', 'RTMAX', 'NP', 'NT', 'BLINDING')}
        if i == 0:
            header['OMEGAM'] = omega_m
        hdus.append({'name': hdu.name, 'header': header,
                     'columns': dict(hdu.columns)})
    write_fits(path, hdus)


def make_jax_metal_dataset(workdir, metals, cross=True, size='full',
                           sample=None, seed=0, noise=0.0, extra_control='',
                           with_distortion=False, extra_model='',
                           new_metals=False, global_cov=False,
                           extra_metals='', qso_z_evol=None):
    """main.ini of a synthetic dataset with `metals` in every LYA tracer,
    written and given its data vectors by vega_tpu alone (the arguments
    are the port's make_synthetic_dataset's)."""
    from vega_tpu import testing as jt
    from vega_tpu.io.fits import read_fits, write_fits
    from vega_tpu.models.eisenstein_hu import make_fiducial_template
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import (OMEGA_M, metals_section,
                                        new_metals_lines, new_metals_weights,
                                        with_qso_z_evol)

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tiny = size == 'tiny'
    nt = 10 if tiny else 50
    model_lines = ('num_bins_muk = 50\nell_max = 6\n' if tiny else '')
    if not isinstance(extra_model, dict):
        extra_model = {'auto': extra_model, 'cross': extra_model}
    template_file = workdir / 'fiducial_eh98.fits'
    make_fiducial_template(template_file, n_k=128 if tiny else 814)

    z_eff = 2.33
    stack_file = workdir / 'delta_stack.fits'
    catalog_file = workdir / 'qso_catalog.fits'
    if new_metals:
        weights = new_metals_weights(seed)
        write_fits(stack_file, [{'name': 'STACK',
                                 'columns': weights['stack']}])
        write_fits(catalog_file, [{'name': 'CAT',
                                   'columns': weights['catalog']}])

    def write_data(path, is_cross, **kwargs):
        coords = jt._write_correlation_data(
            path, is_cross, z_eff, rng, noise=noise, nt=nt,
            with_distortion=with_distortion, **kwargs)
        if new_metals:
            _with_omega_m(path, OMEGA_M)
        return coords

    ini_files, data_files = [], {}
    for is_cross, stem, ini_name, ini_text in (
            (False, 'cf_synthetic', 'lyaxlya.ini', jt._auto_ini),
            (True, 'xcf_synthetic', 'qsoxlya.ini', jt._cross_ini))[:1 + cross]:
        data_file = data_files[is_cross] = workdir / f'{stem}.fits'
        coords = write_data(data_file, is_cross)
        lines = model_lines + extra_model['cross' if is_cross else 'auto']
        if new_metals:
            extra_data, new_model, matrix_section = new_metals_lines(
                stack_file, catalog_file, is_cross)
            text = ini_text(data_file, extra_model=new_model + lines + '\n'
                            + metals_section('None', metals, is_cross,
                                             extra_metals)
                            + '\n' + matrix_section)
        else:
            metal_file = workdir / f'metal_{stem}.fits'
            jt.write_metal_file(
                metal_file, coords, z_eff, 'QSO' if is_cross else 'LYA',
                'LYA', metals_in1=() if is_cross else metals,
                metals_in2=metals,
                rp_shifts=jt.metal_rp_shifts(metals, z_eff))
            text = ini_text(data_file, extra_model=lines + '\n'
                            + metals_section(metal_file, metals, is_cross,
                                             extra_metals))
            # identity metal matrices: `test = True` under [data]
            extra_data = 'test = True\n'
        line = f'filename = {data_file}\n'
        assert text.count(line) == 1
        ini_files.append(workdir / ini_name)
        ini_files[-1].write_text(with_qso_z_evol(
            text.replace(line, line + extra_data), qso_z_evol))

    main_path = workdir / 'main.ini'
    main_path.write_text(jt._main_ini(
        ini_files, template_file, workdir / 'output', sample=sample,
        zeff=z_eff, extra_control=extra_control))
    vega = VegaInterface(main_path)
    model_cf = vega.compute_model(run_init=False)
    for name, corr_item in vega.corr_items.items():
        is_cross = corr_item.tracer1['type'] != corr_item.tracer2['type']
        write_data(data_files[is_cross], is_cross,
                   model_xi=np.asarray(model_cf[name]))
    if global_cov:
        # vega_tpu/testing.py:299-316
        blocks = [read_fits(data_files[item.tracer1['type']
                                       != item.tracer2['type']])[1]['CO']
                  for item in vega.corr_items.values()]
        n_total = sum(b.shape[0] for b in blocks)
        cov = np.zeros((n_total, n_total))
        off = 0
        for b in blocks:
            cov[off:off + len(b), off:off + len(b)] = b
            off += len(b)
        global_cov_file = workdir / 'global_cov.fits'
        write_fits(global_cov_file, [{'name': 'COV',
                                      'columns': {'COV': cov}}])
        main_path.write_text(jt._main_ini(
            ini_files, template_file, workdir / 'output', sample=sample,
            zeff=z_eff, global_cov_file=global_cov_file,
            extra_control=extra_control))
    return main_path
