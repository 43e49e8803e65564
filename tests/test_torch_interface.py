"""chi2, log_lik and chi2_batch of the PyTorch port against the JAX
package's dense path (VEGA_TPU_FACTORED=0), on tiny synthetic datasets,
and against the JAX goldens of the full configuration
(tests/data/torch_port_goldens.json, made by
tests/tools/make_torch_port_goldens.py)."""

import json
from pathlib import Path

import numpy as np
import pytest

from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import state
from vega_tpu_torch.testing import make_synthetic_dataset
from vega_tpu_torch.vega_interface import PENALTY_CHI2, VegaInterface

from test_torch_host import jax_constants

CHI2_RTOL = 1e-9
GOLDEN_RTOL = 1e-8
GOLDENS = Path(__file__).parent / 'data' / 'torch_port_goldens.json'

BATCH = {
    'ap': [1.0, 1.03, 0.96, 1.07, 100.0, 0.99],
    'at': [1.0, 0.98, 1.05, 0.94, 1.0, 1.01],
    'bias_LYA': [-0.117, -0.12, -0.11, -0.125, -0.117, -0.118],
    'beta_LYA': [1.67, 1.7, 1.62, 1.58, 1.67, 1.66],
}
OOB_ROW = 4     # ap = 100 rescales r beyond the transform's knots


@pytest.fixture(scope='module')
def dense_env():
    """The JAX package reads VEGA_TPU_FACTORED at trace time, the port at
    construction: keep both at the dense path for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        yield


def make_pair(workdir, with_distortion=False):
    """(JAX interface, the JAX chi2_batch of BATCH, port on its own
    constants, port on the JAX constants) for a tiny dataset."""
    main = jax_make_dataset(workdir, cross=True, size='tiny',
                            with_distortion=with_distortion)
    # a Gaussian prior on a sampled parameter enters chi^2 and log_lik
    main.write_text(main.read_text()
                    + '\n[priors]\nbeta_LYA = gaussian 1.6 0.2\n')
    jax_vega = JaxInterface(main)
    want = np.asarray(jax_vega.chi2_batch(
        {k: np.asarray(v) for k, v in BATCH.items()}))
    loaded = VegaInterface(main, device='cpu')
    state.load_constants(loaded, jax_constants(jax_vega))
    return jax_vega, want, VegaInterface(main, device='cpu'), loaded


@pytest.fixture(scope='module')
def pair(dense_env, tmp_path_factory):
    return make_pair(tmp_path_factory.mktemp('plain'))


@pytest.fixture(scope='module')
def distorted(dense_env, tmp_path_factory):
    """The same with a (banded) distortion matrix in the data."""
    return make_pair(tmp_path_factory.mktemp('dist'), with_distortion=True)


def rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))
                  / np.abs(np.asarray(want)))


@pytest.mark.parametrize('data', ['plain', 'distortion'])
@pytest.mark.parametrize('constants', ['own', 'loaded'])
def test_chi2_batch_matches_jax(request, data, constants):
    _, want, own, loaded = request.getfixturevalue(
        'pair' if data == 'plain' else 'distorted')
    port = own if constants == 'own' else loaded
    got = port.chi2_batch(BATCH).numpy()
    assert want[OOB_ROW] == PENALTY_CHI2 and got[OOB_ROW] == PENALTY_CHI2
    keep = np.arange(len(got)) != OOB_ROW
    assert rel(got[keep], want[keep]) <= CHI2_RTOL


def test_chi2_and_log_lik_match_jax(pair):
    jax_vega, _, port, _ = pair
    point = {k: v[1] for k, v in BATCH.items()}
    assert rel(port.chi2(point), jax_vega.chi2(point)) <= CHI2_RTOL
    assert rel(port.log_lik(point), jax_vega.log_lik(point)) <= CHI2_RTOL
    assert rel(port.log_lik(), jax_vega.log_lik()) <= CHI2_RTOL
    # at the defaults only the prior is left: ((1.67 - 1.6) / 0.2)^2
    assert abs(port.chi2() - 0.1225) < 1e-12
    assert port.chi2({'ap': 100.0}) == PENALTY_CHI2 == jax_vega.chi2(
        {'ap': 100.0})


def test_log_lik_batch_matches_jax(pair):
    """log_lik_batch = log-normalisation - chi2 / 2 + the priors' own
    normalisation, as vega_tpu.VegaInterface.log_lik_batch."""
    jax_vega, want_chi2, port, _ = pair
    want = (jax_vega._log_norm() - 0.5 * want_chi2[1:4]
            + sum(jax_vega._gaussian_lik_prior(prior[1])
                  for prior in jax_vega.priors.values()))
    batch = {k: v[1:4] for k, v in BATCH.items()}
    assert rel(port.log_lik_batch(batch).numpy(), want) <= CHI2_RTOL


def test_chunked_batch_equals_one_chunk(pair, monkeypatch):
    """Chunks change only the GEMM blocking: equal to round-off."""
    import vega_tpu_torch.vega_interface as vi
    _, _, port, _ = pair
    whole = port.chi2_batch(BATCH).numpy()
    monkeypatch.setattr(vi, 'CHUNK_ROWS', 4)
    np.testing.assert_allclose(port.chi2_batch(BATCH).numpy(), whole,
                               rtol=1e-12, atol=1e-12)


def test_full_configuration_matches_jax_goldens(dense_env, tmp_path):
    """The port alone (no JAX involved) on the full synthetic
    configuration against the JAX package's dense chi^2, both on the
    dense path (VEGA_TPU_FACTORED=0, read by the port at construction)."""
    goldens = json.loads(GOLDENS.read_text())
    port = VegaInterface(make_synthetic_dataset(tmp_path, cross=True,
                                                size='full', device='cpu'),
                         device='cpu')
    got = port.chi2_batch(goldens['params']).numpy()
    assert rel(got, goldens['chi2']) <= GOLDEN_RTOL
