"""Several processes (counterpart of vega_tpu/parallel/distributed.py).

vega_tpu scales across hosts with jax.distributed: every host runs the
same script, `initialize()` joins them, and the global mesh spans every
device. Here `initialize` joins the processes in a torch.distributed
process group, `global_mesh` is a DeviceMesh over every process's
devices, host-major, and `BatchedLikelihood.chi2` over such a mesh
computes this process's rows and all-gathers the rest, so that every
process holds every value (vega_tpu's process_allgather).

The group runs on the gloo backend: the gather moves a few host numbers
per row, and NCCL refuses two ranks on one GPU ("duplicate GPU"), which
is how two processes share a one-card host.

Usage in each process (the same script everywhere):

    from vega_tpu_torch.parallel import initialize, global_mesh
    initialize('host:port', num_processes=2, process_id=rank)
    mesh = global_mesh()              # every process's cards, host-major
    bl = BatchedLikelihood(vega, mesh=mesh)
"""

from __future__ import annotations

import os

import torch

from .batch import DeviceMesh, cuda_devices

BACKEND = 'gloo'


def _dist():
    import torch.distributed as dist
    return dist


def _initialized():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count():
    return _dist().get_world_size() if _initialized() else 1


def process_index():
    return _dist().get_rank() if _initialized() else 0


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """torch.distributed.init_process_group (gloo) for `num_processes`
    processes, this one `process_id`, meeting at `coordinator_address`
    ('host:port' or a 'tcp://' URL). Absent arguments come from
    MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK. Returns at once when
    the group exists already; without a coordinator address (argument or
    environment) it prints vega_tpu's INFO line and runs as one process
    (vega_tpu/parallel/distributed.py:27-45). A group that is asked for
    and fails to form raises."""
    if _initialized():
        return
    env = os.environ
    if coordinator_address is None and not (
            env.get('MASTER_ADDR') and env.get('MASTER_PORT')):
        print('INFO: torch.distributed not initialized (no coordinator '
              'address: pass coordinator_address or set MASTER_ADDR and '
              'MASTER_PORT); running single-host.')
        return
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f'tcp://{coordinator_address}'
    world_size = int(num_processes if num_processes is not None
                     else env['WORLD_SIZE'])
    rank = int(process_id if process_id is not None else env['RANK'])
    _dist().init_process_group(BACKEND, init_method=init_method,
                               world_size=world_size, rank=rank)


def global_mesh(axis_name='batch', devices=None):
    """1-D mesh over every process's devices, host-major (process 0's
    first), so a sharded batch keeps each process's rows on its own
    devices. A process's devices are `devices` (given in each process;
    e.g. ['cpu'] for a group on the CPU), else every CUDA device it
    sees."""
    local = [torch.device(d) for d in (cuda_devices() if devices is None
                                       else devices)]
    if process_count() == 1:
        return DeviceMesh(local, (axis_name,))
    everyone = [None] * process_count()
    _dist().all_gather_object(everyone, [str(d) for d in local])
    devices, ranks = [], []
    for rank, names in enumerate(everyone):
        devices += names
        ranks += [rank] * len(names)
    return DeviceMesh(devices, (axis_name,), ranks)


def local_batch_slice(total_batch):
    """The [start, stop) slice of a global batch this process owns; the
    last process takes the remainder."""
    per_proc = total_batch // process_count()
    start = process_index() * per_proc
    stop = (start + per_proc if process_index() < process_count() - 1
            else total_batch)
    return start, stop
