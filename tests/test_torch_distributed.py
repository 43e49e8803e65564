"""Several processes in the PyTorch port (vega_tpu_torch.parallel:
initialize, global_mesh, local_batch_slice, BatchedLikelihood and
ShardedGlobalChi2 over a mesh that spans processes), as
tests/test_multihost_dcn.py runs two processes for vega_tpu: two OS
processes on the CPU join one gloo process group, each lists the CPU
twice in the global mesh (four entries), and each must hold every
gathered value, equal to the serial evaluation in this process.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vega_tpu_torch.parallel import (global_mesh, initialize,
                                     local_batch_slice)
from vega_tpu_torch.parallel import distributed
from vega_tpu_torch.testing import make_synthetic_dataset
from vega_tpu_torch.vega_interface import VegaInterface

REPO = Path(__file__).resolve().parents[1]
N_ROWS = 13
# the gathered chi^2 against the serial chi2_batch of this process,
# relative to |chi^2| (the same f64 rows, evaluated in other processes)
GATHER_RTOL = 1e-12
WORKER_TIMEOUT_S = 240

WORKER = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from vega_tpu_torch.parallel import (BatchedLikelihood, ShardedGlobalChi2,
                                     global_mesh, initialize,
                                     local_batch_slice)
from vega_tpu_torch.parallel.distributed import process_count, process_index
from vega_tpu_torch.vega_interface import VegaInterface

rank, address, main, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
initialize(address, num_processes=2, process_id=rank)
initialize(address, num_processes=2, process_id=rank)   # returns at once
mesh = global_mesh(devices=['cpu', 'cpu'])
vega = VegaInterface(main, device='cpu')
batch = {k: np.asarray(v) for k, v in json.loads(sys.argv[5]).items()}
chi2 = BatchedLikelihood(vega, mesh=mesh).chi2(batch)
rng = np.random.default_rng(0)
a = rng.normal(size=(37, 37))
invcov = a @ a.T + 37 * np.eye(37)
diffs = rng.normal(size=(3, 37))
quad = ShardedGlobalChi2(invcov, mesh=mesh).chi2_batch(diffs)
json.dump({'count': process_count(), 'index': process_index(),
           'slice': list(local_batch_slice(N_ROWS)),
           'mesh': [str(d) for d in mesh.devices], 'ranks': list(mesh.ranks),
           'local': mesh.local_entries, 'chi2': chi2.tolist(),
           'quad': quad.tolist(),
           'quad_want': np.einsum('bi,ij,bj->b', diffs, invcov,
                                  diffs).tolist()}, open(out, 'w'))
'''.replace('N_ROWS', str(N_ROWS))


def free_port():
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def test_single_process_without_a_coordinator(monkeypatch, capsys):
    """No coordinator (argument or MASTER_ADDR / MASTER_PORT): vega_tpu's
    INFO line and one process, its slice the whole batch."""
    monkeypatch.delenv('MASTER_ADDR', raising=False)
    monkeypatch.delenv('MASTER_PORT', raising=False)
    initialize()
    assert 'running single-host' in capsys.readouterr().out
    assert distributed.process_count() == 1
    assert local_batch_slice(N_ROWS) == (0, N_ROWS)
    mesh = global_mesh(devices=['cpu', 'cpu'])
    assert mesh.size == 2 and not mesh.spans_processes


def test_two_processes_gather_the_serial_values(tmp_path):
    """Two gloo processes: process count and index, each one's slice
    (the last takes the remainder), a host-major mesh of four entries,
    the chi^2 of 13 rows over it held by both processes and equal to the
    serial chi2_batch (GATHER_RTOL), and the sharded quadratic form of a
    37 x 37 inverse covariance to numpy's (1e-12)."""
    main = make_synthetic_dataset(tmp_path, cross=False, size='tiny',
                                  device='cpu')
    rng = np.random.default_rng(2)
    batch = {'bias_LYA': rng.uniform(-0.13, -0.11, N_ROWS).tolist(),
             'beta_LYA': rng.uniform(1.5, 1.8, N_ROWS).tolist()}
    address = f'localhost:{free_port()}'
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    for key in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, '-c', WORKER, str(rank), address, str(main),
         str(tmp_path / f'rank{rank}.json'), json.dumps(batch)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]

    serial = VegaInterface(main, device='cpu').chi2_batch(
        {k: np.asarray(v) for k, v in batch.items()}).numpy()
    for rank in (0, 1):
        got = json.loads((tmp_path / f'rank{rank}.json').read_text())
        assert got['count'] == 2 and got['index'] == rank
        assert got['slice'] == ([0, 6] if rank == 0 else [6, N_ROWS])
        assert got['mesh'] == ['cpu'] * 4
        assert got['ranks'] == [0, 0, 1, 1]
        assert got['local'] == ([0, 1] if rank == 0 else [2, 3])
        chi2 = np.asarray(got['chi2'])
        assert chi2.shape == (N_ROWS,)
        assert np.max(np.abs(chi2 - serial) / np.abs(serial)) <= GATHER_RTOL
        np.testing.assert_allclose(got['quad'], got['quad_want'],
                                   rtol=1e-12)
    assert torch.distributed.is_available()
