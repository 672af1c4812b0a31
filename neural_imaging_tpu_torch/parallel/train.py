"""
Data-parallel training: port of ``neural_imaging_tpu/parallel/train.py``.

:class:`DataParallel` is what the trainers take as ``parallel=``: the mesh
(the process group and this rank's device), the broadcast of a model's or a
flow's parameters and optimizer state from rank 0 (``distribute``), this
rank's rows of a global batch (``shard``), and the gradient reduction of a
step (``reduce``). A step of a distributed model or flow computes the JAX
package's step over the global batch: each rank differentiates its share of
the global loss on its rows, the forward's batch reductions run over all
ranks (``mesh.batch_reductions``), and one all-reduce sums the gradients
and the logged loss terms, so every rank applies the same Adam update.

The ranks are processes, started by ``parallel/launch.py`` (the library's
``run`` or a CLI's ``--devices n``) or by hand with ``--coordinator
host:port --nproc n --procid i`` (``multihost.initialize``).
"""
import torch

from neural_imaging_tpu_torch.parallel import mesh as mesh_lib
from neural_imaging_tpu_torch.parallel import multihost
from neural_imaging_tpu_torch.utils.utils import logger


def distribute_model(model, mesh):
    """Broadcast a model's parameters and Adam state from rank 0."""
    mesh_lib.replicate(list(model.module.parameters()), mesh)
    if getattr(model, 'optimizer', None) is not None:
        mesh_lib.replicate(mesh_lib.optimizer_tensors(model.optimizer), mesh)
    return model


def distribute_workflow(flow, mesh):
    """Broadcast the joint workflow's parameter partitions and Adam state
    from rank 0."""
    mesh_lib.replicate([p for part in flow._collect_params().values() for p in part.values()],
                       mesh)
    mesh_lib.replicate(mesh_lib.optimizer_tensors(flow.optimizer), mesh)
    return flow


def shard_batch_args(mesh, *arrays):
    """This rank's rows of each global batch."""
    return tuple(mesh_lib.shard_batch(a, mesh) for a in arrays)


def pad_batch_to_devices(batch, mesh):
    """Pad a batch (repeating its last row) so that its leading dimension
    divides over the ranks; returns (padded, original size)."""
    import numpy as np
    n = mesh.world_size
    b = batch.shape[0]
    if b % n == 0:
        return batch, b
    pad = n - b % n
    if torch.is_tensor(batch):
        return torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])]), b
    return np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)], axis=0), b


def sharded_inference(model, batch, mesh):
    """``model.process`` of a global batch, each rank developing its rows;
    every rank returns the whole result (on its device)."""
    padded, orig = pad_batch_to_devices(batch, mesh)
    out = model.process(mesh_lib.shard_batch(padded, mesh))
    gathered = mesh_lib.all_gather_flat(out, mesh)
    return gathered.reshape(padded.shape[0], *out.shape[1:])[:orig]


def count_devices(spec, device='cuda'):
    """The number of ranks ``spec`` asks for: 'auto' is every rank of the
    process group that this process joined, else every card of this host
    (one on the CPU); an int or an int string that many. Asking for more
    cards than this host has is an error, outside a process group that may
    span hosts."""
    device = torch.device(device)
    grouped = multihost.process_count() > 1
    if spec == 'auto':
        if grouped:
            return multihost.process_count()
        return torch.cuda.device_count() if device.type == 'cuda' else 1
    n = int(spec)
    if n < 1:
        raise ValueError(f'--devices {spec}: at least one device')
    if device.type == 'cuda' and not grouped and n > torch.cuda.device_count():
        raise ValueError(f'--devices {n} asks for {n} CUDA devices; this machine has '
                         f'{torch.cuda.device_count()}')
    return n


def resolve_count(spec, batch_size=None, device='cuda'):
    """``count_devices``, shrunk (with a warning) to the largest divisor of
    ``batch_size`` so that the ranks hold equal shares; 1 for None/'none'."""
    if spec in (None, 'none', ''):
        return 1
    n = count_devices(spec, device)
    if batch_size is not None and batch_size % n != 0:
        best = max(d for d in range(1, n + 1) if batch_size % d == 0)
        logger.warning('batch size %d does not divide over %d devices; using %d', batch_size,
                       n, best)
        n = best
    return n


class DataParallel:
    """
    The data-parallel context of the trainers (the JAX package's
    ``DataParallel``): built from the CLI's ``--devices`` in each rank's
    process, it carries the mesh. Parameters and optimizer state stay
    replicated; a step's gradients are summed over the ranks in one
    all-reduce (``reduce``).
    """

    def __init__(self, mesh):
        self.mesh = mesh

    @classmethod
    def from_spec(cls, spec, batch_size=None, device='cuda'):
        """
        ``spec``: None/'none' → None (the single-device path); 'auto' → every
        rank of the group (every local card without one); an int → that
        many. A ``batch_size`` that does not divide shrinks the count to its
        largest divisor, with a warning. More than one rank needs this
        process to be one of a group of that size (``multihost.initialize``).
        """
        n = resolve_count(spec, batch_size, device)
        if n <= 1:
            return None
        world = multihost.process_count()
        if world != n:
            raise ValueError(
                f'{n} data-parallel ranks requested, but this process is one of {world}: '
                'start the ranks with parallel.launch (a CLI\'s --devices n) or join a '
                'group with --coordinator/--nproc/--procid')
        return cls(mesh_lib.make_mesh(device))

    @property
    def n_devices(self):
        return self.mesh.world_size

    @property
    def rank(self):
        return self.mesh.rank

    @property
    def device(self):
        return self.mesh.device

    def check_batch(self, batch_size, what='batch size'):
        if batch_size % self.n_devices != 0:
            raise ValueError(f'{what} ({batch_size}) must divide across the '
                             f'{self.n_devices} data-parallel ranks')

    def distribute(self, model_or_flow):
        """Give a model or a workflow this context (its steps then reduce over
        the ranks) and broadcast its state from rank 0."""
        model_or_flow.parallel = self
        if hasattr(model_or_flow, 'fan'):  # the joint workflow
            return distribute_workflow(model_or_flow, self.mesh)
        return distribute_model(model_or_flow, self.mesh)

    def shard(self, *arrays):
        return shard_batch_args(self.mesh, *arrays)

    def reduce(self, grads, values=()):
        """Sum a step's gradients (tensors, each rank's share of the global
        loss) and ``values`` (0-d terms to log) over the ranks in one
        all-reduce; returns (grads, values), both summed."""
        grads, values = list(grads), list(values)
        out = mesh_lib.reduce_sum(self.mesh, grads + values)
        return out[:len(grads)], out[len(grads):]

    def describe(self):
        return (f'data-parallel over {self.n_devices} ranks ({self.device.type}, '
                f'{self.mesh.backend})')


def add_cli_args(parser):
    """Attach the shared scale-out flags to a trainer CLI parser."""
    parser.add_argument('--devices', default=None,
                        help="data-parallel ranks: an int (ranks started on this host, one "
                             "device each), 'auto' (every card of this host) or 'none' "
                             '(default, one device)')
    parser.add_argument('--coordinator', default=None,
                        help='multi-process: the coordinator address host:port (rank 0 '
                             'serves it)')
    parser.add_argument('--nproc', type=int, default=None,
                        help='multi-process: total number of processes')
    parser.add_argument('--procid', type=int, default=None,
                        help='multi-process: this process id')
    return parser


def rank_device(device, procid=None):
    """This rank's device: a bare 'cuda' of rank ``procid`` is card
    procid mod the host's cards; anything else as given."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None and procid is not None:
        return torch.device('cuda', int(procid) % max(1, torch.cuda.device_count()))
    return device


def from_cli_args(args, batch_size=None):
    """Join the process group the flags name (if any) and build the
    DataParallel context; returns None for the single-device path. Sets
    ``args.device`` to this rank's device."""
    device = rank_device(args.device, args.procid)
    multihost.initialize(args.coordinator, args.nproc, args.procid, device=device)
    args.device = str(device)
    spec = args.devices
    if spec is None and args.coordinator is not None:
        spec = 'auto'  # multi-process runs default to every rank of the group
    return DataParallel.from_spec(spec, batch_size=batch_size, device=device)
