"""The JAX package's (vega_tpu) side of a synthetic dataset with metals.

vega_tpu.testing.make_synthetic_dataset has no metals option: its DR16
example writes the metal files and the [metals] sections by hand
(examples/eBOSS_DR16/run_synthetic.py:106-125). `make_jax_metal_dataset`
does the same with vega_tpu's own functions, in the order of
vega_tpu_torch.testing.make_synthetic_dataset(..., metals=...), so the
two packages' files from the same arguments can be held against each
other, and vega_tpu can be run on the configuration the port runs
(tests/test_torch_metals.py, tests/tools/make_torch_port_dr16_goldens.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def make_jax_metal_dataset(workdir, metals, cross=True, size='full',
                           sample=None, seed=0, noise=0.0, extra_control='',
                           with_distortion=False, extra_model=''):
    """main.ini of a synthetic dataset with `metals` in every LYA tracer,
    written and given its data vectors by vega_tpu alone."""
    from vega_tpu import testing as jt
    from vega_tpu.models.eisenstein_hu import make_fiducial_template
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import metals_section

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tiny = size == 'tiny'
    nt = 10 if tiny else 50
    model_lines = ('num_bins_muk = 50\nell_max = 6\n' if tiny else '')
    model_lines += extra_model
    template_file = workdir / 'fiducial_eh98.fits'
    make_fiducial_template(template_file, n_k=128 if tiny else 814)

    z_eff = 2.33
    ini_files, data_files = [], {}
    for is_cross, stem, ini_name, ini_text in (
            (False, 'cf_synthetic', 'lyaxlya.ini', jt._auto_ini),
            (True, 'xcf_synthetic', 'qsoxlya.ini', jt._cross_ini))[:1 + cross]:
        data_file = data_files[is_cross] = workdir / f'{stem}.fits'
        coords = jt._write_correlation_data(
            data_file, is_cross, z_eff, rng, noise=noise, nt=nt,
            with_distortion=with_distortion)
        metal_file = workdir / f'metal_{stem}.fits'
        jt.write_metal_file(
            metal_file, coords, z_eff, 'QSO' if is_cross else 'LYA', 'LYA',
            metals_in1=() if is_cross else metals, metals_in2=metals,
            rp_shifts=jt.metal_rp_shifts(metals, z_eff))
        text = ini_text(data_file, extra_model=model_lines + '\n'
                        + metals_section(metal_file, metals, is_cross))
        # identity metal matrices: `test = True` under [data]
        line = f'filename = {data_file}\n'
        assert text.count(line) == 1
        ini_files.append(workdir / ini_name)
        ini_files[-1].write_text(text.replace(line, line + 'test = True\n'))

    main_path = workdir / 'main.ini'
    main_path.write_text(jt._main_ini(
        ini_files, template_file, workdir / 'output', sample=sample,
        zeff=z_eff, extra_control=extra_control))
    vega = VegaInterface(main_path)
    model_cf = vega.compute_model(run_init=False)
    for name, corr_item in vega.corr_items.items():
        is_cross = corr_item.tracer1['type'] != corr_item.tracer2['type']
        jt._write_correlation_data(
            data_files[is_cross], is_cross, z_eff, rng,
            model_xi=np.asarray(model_cf[name]), noise=noise, nt=nt,
            with_distortion=with_distortion)
    return main_path
