"""
Multi-process scale-out: port of ``neural_imaging_tpu/parallel/multihost.py``.

One process per rank, joined by ``torch.distributed`` over TCP (the
coordinator's ``host:port``), each with one device. The group has a finite
timeout, so a rank that hangs fails the others instead of holding them.
Without a coordinator everything here is a single-process no-op, so the
same trainers run anywhere.

The backend follows from the ranks' devices: NCCL where every rank has a
card of its own, gloo on the CPU. ``backend='gloo'`` may be asked for with
cards (two ranks sharing one card); two ranks on one card over NCCL are
refused, and nothing switches backend on its own.
"""
import datetime
import functools
import os
import socket

import torch
import torch.distributed as dist

from neural_imaging_tpu_torch.parallel import mesh as mesh_lib
from neural_imaging_tpu_torch.utils.utils import logger

# how long a collective (or joining the group) may wait before the run fails
DEFAULT_TIMEOUT_S = 600


def default_backend(device):
    return 'gloo' if torch.device(device).type == 'cpu' else 'nccl'


def initialize(coordinator_address=None, num_processes=None, process_id=None, device='cuda',
               backend=None, timeout_s=DEFAULT_TIMEOUT_S):
    """Join the process group of ``num_processes`` ranks at
    ``coordinator_address`` ('host:port', served by rank 0) as rank
    ``process_id``, this rank on ``device``. Returns False (and does
    nothing) without a coordinator and a process count."""
    if coordinator_address is None and num_processes is None and process_id is None:
        logger.info('multihost: single-process mode (torch.distributed not initialized)')
        return False
    missing = [name for name, value in (('coordinator', coordinator_address),
                                        ('nproc', num_processes), ('procid', process_id))
               if value is None]
    if missing:
        raise ValueError(f'a multi-process run needs --coordinator, --nproc and --procid; '
                         f'missing {", ".join("--" + m for m in missing)}')
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f'--procid {process_id} outside --nproc {num_processes}')
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    backend = backend or default_backend(device)
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'the NCCL backend needs a CUDA device, not {device}')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    host, _, port = coordinator_address.rpartition(':')
    dist.init_process_group(backend, init_method=f'tcp://{host or "127.0.0.1"}:{int(port)}',
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == 'nccl':
        _refuse_shared_cards(device)
    logger.info('multihost: rank %d/%d on %s over %s', dist.get_rank(), dist.get_world_size(),
                device, backend)
    return True


def _refuse_shared_cards(device):
    """NCCL needs a card per rank: refuse two ranks on one card."""
    props = torch.cuda.get_device_properties(device)
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (socket.gethostname(), str(getattr(props, 'uuid',
                                                                     device.index))))
    if len(set(where)) < len(where):
        dist.destroy_process_group()
        raise ValueError(f'ranks share a card ({where}); NCCL needs one card per rank: '
                         "pass backend='gloo' to run several ranks on one card")


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(device):
    """The mesh over all ranks (call after :func:`initialize`)."""
    return mesh_lib.make_mesh(device)


def process_count():
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary():
    """True on the rank that writes files (rank 0, or the only process)."""
    return process_index() == 0


def primary_only(fn):
    """Decorator running ``fn`` on the primary only (file writers); None elsewhere."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None
    return wrapper


def local_batch_slice(global_batch_size):
    """(start, size) of this process's rows of a global batch."""
    per_process = global_batch_size // process_count()
    return process_index() * per_process, per_process


def sync_global_value(value, device='cpu'):
    """The mean of a scalar over the processes (one all-reduce)."""
    if process_count() == 1:
        return float(value)
    mesh = mesh_lib.make_mesh(device)
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    return float(mesh_lib.all_reduce_sum(t, mesh)[0]) / mesh.world_size


def agree(obj):
    """Rank 0's ``obj`` on every rank (a picklable value; identity alone)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def free_port():
    """A TCP port free on this host now, for a coordinator on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def rank_environment():
    """The environment a rank's process runs with: this package importable
    from any working directory, and one CPU thread per rank unless the
    caller set a count."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env['PYTHONPATH'] = os.pathsep.join(p for p in (root, env.get('PYTHONPATH')) if p)
    env.setdefault('OMP_NUM_THREADS', '1')
    return env
