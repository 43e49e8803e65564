"""A fit from the command line in the PyTorch port
(vega_tpu_torch.scripts.run_vega, vega_tpu_torch.cli) against the JAX
package's run_vega, on the CPU at size='tiny', mirroring
tests/test_scripts.py:15-29 on its configuration with the components
written: the results file (BESTFIT, MODEL_*, PK_* and Xi_*) and the wedge
and shell plots, `cli fit` against run_vega, the fit and its file with
matplotlib blocked, the card as the entry points' default device, and
the cli's dispatch. Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import sys

import matplotlib

matplotlib.use('Agg')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vega_tpu.io.fits import read_fits as jax_read_fits  # noqa: E402
from vega_tpu.scripts.run_vega import run_vega as jax_run_vega  # noqa: E402
from vega_tpu.testing import make_synthetic_dataset  # noqa: E402
from vega_tpu_torch import cli  # noqa: E402
from vega_tpu_torch.io.fits import read_fits  # noqa: E402
from vega_tpu_torch.scripts import run_vega  # noqa: E402

COMPONENT_RTOL = 1e-12  # a component column, of its largest entry
MODEL_RTOL = 1e-12      # a MODEL_ column, of its largest entry
# the best fits: values within VALUE_SIGMA of vega_tpu's errors, errors
# within ERROR_RTOL of them (the minimizers are copies, the chi^2 agree
# to round-off)
VALUE_SIGMA, ERROR_RTOL = 1e-3, 1e-5


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield


@pytest.fixture(scope='module')
def config(tmp_path_factory):
    """tests/test_scripts.py:18's configuration with write_pk and
    write_cf; `ini(stem)` writes a copy whose results go to
    <dir>/<stem>/results."""
    main = make_synthetic_dataset(tmp_path_factory.mktemp('run_vega'),
                                  cross=False, size='tiny', noise=1.0)

    def ini(stem):
        parser = configparser.ConfigParser()
        parser.optionxform = str
        parser.read(main)
        (main.parent / stem).mkdir()
        parser['output'].update(
            filename=str(main.parent / stem / 'results'),
            write_pk='True', write_cf='True')
        path = main.parent / f'{stem}.ini'
        with open(path, 'w') as fh:
            parser.write(fh)
        return path

    return ini


@pytest.fixture(scope='module')
def runs(config):
    """run_vega of each package and the port's `cli fit`: what each
    returned and its results file."""
    out = {}
    for label, run in (
            ('port', lambda ini: run_vega.run_vega(ini, 'cpu')),
            ('jax', jax_run_vega),
            ('cli', lambda ini: cli.main(['fit', str(ini),
                                          '--device', 'cpu']))):
        ini = config(label)
        out[label] = {'result': run(ini),
                      'fits': ini.parent / label / 'results.fits'}
    return out


def hdus(path, reader):
    return {h.name: h for h in reader(path) if getattr(h, 'name', '')}


def test_run_vega_matches_jax(runs):
    """The port's results file against vega_tpu's, each read by both
    packages' readers: the same HDUs and columns; the best fit within
    VALUE_SIGMA / ERROR_RTOL; MODEL_ and the components within
    MODEL_RTOL / COMPONENT_RTOL; a wedge and a shell plot per
    correlation beside both files."""
    got = hdus(runs['port']['fits'], jax_read_fits)
    want = hdus(runs['jax']['fits'], read_fits)
    assert set(got) == set(want) == {'MODEL_lyaxlya', 'BESTFIT',
                                     'PK_lyaxlya', 'Xi_lyaxlya'}
    best_got, best_want = got['BESTFIT'], want['BESTFIT']
    assert [str(n) for n in best_got['names']] == \
        [str(n) for n in best_want['names']]
    errors = np.asarray(best_want['errors'])
    assert np.max(np.abs(np.asarray(best_got['values'])
                         - best_want['values']) / errors) <= VALUE_SIGMA
    assert max_rel(best_got['errors'], errors) <= ERROR_RTOL
    for name in ('PK_lyaxlya', 'Xi_lyaxlya', 'MODEL_lyaxlya'):
        assert set(got[name].columns) == set(want[name].columns)
        for col in want[name].columns:
            a, b = np.asarray(got[name][col]), np.asarray(want[name][col])
            if b.dtype.kind == 'f':
                finite = np.isfinite(b)
                assert np.array_equal(finite, np.isfinite(a))
                rtol = MODEL_RTOL if name.startswith('MODEL') \
                    else COMPONENT_RTOL
                assert max_rel(a[finite], b[finite]) <= rtol
            else:
                assert np.array_equal(a, b)
    for label in ('port', 'jax'):
        folder = runs[label]['fits'].parent
        for kind in ('wedges', 'shells'):
            assert (folder / f'results_lyaxlya_{kind}.png').exists()


def test_cli_fit_is_run_vega(runs):
    """`cli fit --device cpu` writes what run_vega writes, bit for bit."""
    got = hdus(runs['cli']['fits'], read_fits)
    want = hdus(runs['port']['fits'], read_fits)
    assert set(got) == set(want)
    for name, hdu in want.items():
        for col in hdu.columns:
            a, b = np.asarray(got[name][col]), np.asarray(hdu[col])
            assert np.array_equal(a, b, equal_nan=b.dtype.kind == 'f')
    assert (runs['cli']['fits'].parent / 'results_lyaxlya_shells.png') \
        .exists()


def test_fit_and_write_without_matplotlib(config, monkeypatch, capsys):
    """Where matplotlib is not installed (blocked in sys.modules here),
    the interface constructs, run_vega fits and writes its file and no
    plot, and only the plots refuse."""
    for module in ('matplotlib', 'matplotlib.pyplot'):
        monkeypatch.setitem(sys.modules, module, None)
    monkeypatch.delitem(sys.modules, 'vega_tpu_torch.plots.plot',
                        raising=False)
    ini = config('no_matplotlib')
    vega = run_vega.run_vega(ini, 'cpu')
    assert 'matplotlib is not installed: no plots' in capsys.readouterr().out
    folder = ini.parent / 'no_matplotlib'
    assert (folder / 'results.fits').exists()
    assert not list(folder.glob('*.png'))
    assert {'PK_lyaxlya', 'Xi_lyaxlya'} <= set(
        hdus(folder / 'results.fits', read_fits))
    with pytest.raises(ImportError):
        vega.plots


def test_entry_points_default_to_the_card(config):
    """run_vega and `cli fit` run on the card unless asked for the CPU:
    here, with no card, they refuse."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device works')
    ini = config('default_device')
    for main in (lambda: run_vega.main([str(ini)]),
                 lambda: cli.main(['fit', str(ini)])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            main()


def test_cli_dispatches_to_the_scripts(monkeypatch):
    """`sample` and `mc` hand their options to the port's scripts."""
    calls = []
    from vega_tpu_torch.scripts import run_vega_mc, run_vega_sampler
    monkeypatch.setattr(run_vega_sampler, 'main',
                        lambda argv: calls.append(('sample', argv)) or 0)
    monkeypatch.setattr(run_vega_mc, 'main',
                        lambda argv: calls.append(('mc', argv)) or 0)
    assert cli.main(['sample', 'a.ini', '--device', 'cpu']) == 0
    assert cli.main(['mc', 'b.ini', '--sequential', '--n-devices', '1']) \
        == 0
    assert calls == [('sample', ['a.ini', '--device', 'cpu']),
                     ('mc', ['b.ini', '--device', 'cuda', '--sequential',
                             '--n-devices', '1'])]
