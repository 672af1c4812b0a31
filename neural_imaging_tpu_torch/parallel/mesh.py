"""
The process group as a "mesh", and the collectives of a data-parallel step:
port of ``neural_imaging_tpu/parallel/mesh.py``.

In JAX a data-parallel step is one SPMD program over the global batch on a
1-D ``('data',)`` mesh. Here every rank is a process with one device and
1/n of the global batch; :class:`Mesh` is the process group plus this
rank's device, ``shard_batch`` cuts this rank's rows out of a global batch
(``local_batch_slice``) and ``replicate`` broadcasts parameters and
optimizer state from rank 0. The 2-D ``('data', 'space')`` mesh of
full-image development is the band planner of ``parallel/spatial.py``.

A step computes the JAX step over the global batch, not a mean of local
steps: wherever the forward pass reduces over the batch nonlinearly (the
DCN's entropy from codeword counts, ``percentile_normalize``, the 'shift'
brightness's mean), it reduces over all ranks while a step's forward runs
under :func:`batch_reductions`. The gradients of a step are summed over the
ranks in one all-reduce of one flat buffer (:func:`reduce_sum`), each rank
having differentiated its share of the global loss.

Collectives go through the default process group. A gloo group gets a CUDA
tensor staged through host memory (gloo's own CUDA paths stage through host
memory too, and not every build has them); NCCL takes it on the card.
"""
import contextlib

import torch
import torch.distributed as dist


class Mesh:
    """The ranks of a data-parallel run and this rank's place in it:
    ``world_size`` ranks, this one ``rank``, on ``device``, over ``backend``
    ('nccl' or 'gloo'; None where no collective runs)."""

    def __init__(self, device, world_size=1, rank=0, backend=None):
        self.device = torch.device(device)
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.backend = backend
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f'rank {rank} outside a world of {world_size}')

    def __repr__(self):
        return (f'Mesh(rank {self.rank}/{self.world_size} on {self.device}, '
                f'{self.backend or "no backend"})')


def make_mesh(device):
    """The mesh of the initialized default process group with this rank on
    ``device``; a one-rank mesh without a group."""
    if not dist.is_available() or not dist.is_initialized():
        return Mesh(device)
    return Mesh(device, dist.get_world_size(), dist.get_rank(), dist.get_backend())


def local_batch_slice(global_batch_size, mesh):
    """(start, size) of this rank's rows of a global batch."""
    if global_batch_size % mesh.world_size:
        raise ValueError(f'a batch of {global_batch_size} does not divide over '
                         f'{mesh.world_size} ranks')
    size = global_batch_size // mesh.world_size
    return mesh.rank * size, size


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (numpy or tensor; None passes)."""
    if batch is None or mesh is None:
        return batch
    start, size = local_batch_slice(batch.shape[0], mesh)
    return batch[start:start + size]


def local_rows(global_tensor, local_size, mesh):
    """This rank's ``local_size`` rows of a tensor drawn for the global batch."""
    return global_tensor[mesh.rank * local_size:(mesh.rank + 1) * local_size]


def replicate(tensors, mesh):
    """Broadcast ``tensors`` (parameters, optimizer state) from rank 0 in
    place, so that every rank starts from rank 0's values."""
    if not collective(mesh):
        return
    with torch.no_grad():
        for t in tensors:
            host = _to_backend(t, mesh)
            dist.broadcast(host, src=0)
            if host is not t:
                t.copy_(host)


def optimizer_tensors(optimizer):
    """The tensors of an optimizer's state (Adam's moments and step counts)."""
    return [v for state in optimizer.state.values() for v in state.values()
            if torch.is_tensor(v)]


# -- collectives --------------------------------------------------------------------

def collective(mesh):
    """Whether ``mesh`` has a process group to talk to (a group of one rank
    has; a single process without a group has not)."""
    return mesh is not None and mesh.backend is not None


def _staged(mesh, t):
    return mesh.backend == 'gloo' and t.device.type == 'cuda'


def _to_backend(t, mesh):
    """``t`` where the backend reads it: host memory for gloo."""
    return t.cpu() if _staged(mesh, t) else t


def all_reduce_sum(t, mesh):
    """Σ over the ranks of ``t``, in place (a copy of a non-contiguous t);
    returns the sum."""
    if not collective(mesh):
        return t
    if not t.is_contiguous():
        t = t.contiguous()
    host = _to_backend(t, mesh)
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    if host is not t:
        t.copy_(host, non_blocking=False)
    return t


def all_gather_flat(t, mesh):
    """The ranks' ``t`` (each of one shape) flattened and concatenated in
    rank order, without gradient."""
    if not collective(mesh):
        return t.reshape(-1)
    flat = _to_backend(t.reshape(-1).contiguous(), mesh)
    parts = [torch.empty_like(flat) for _ in range(mesh.world_size)]
    dist.all_gather(parts, flat)
    return torch.cat(parts).to(t.device)


class _AllGather(torch.autograd.Function):
    """all_gather_flat with a gradient: every rank's loss may read any rank's
    values, so the cotangent of the gathered tensor is summed over the ranks
    and each rank keeps its own block."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.shape, ctx.n = mesh, t.shape, t.numel()
        return all_gather_flat(t.detach(), mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.n
        g = all_reduce_sum(g.contiguous().clone(), mesh)
        return g[mesh.rank * n:(mesh.rank + 1) * n].reshape(ctx.shape), None


class _AllReduceSum(torch.autograd.Function):
    """all_reduce_sum with a gradient: the sum is read by every rank's loss,
    so its cotangent is summed over the ranks too."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(t.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.mesh), None


def gather_global(t, mesh):
    """The global tensor's values, flattened in rank order (the global
    batch's row order), differentiable."""
    return _AllGather.apply(t, mesh)


def global_sum(t, mesh):
    """Σ over the ranks, differentiable."""
    return _AllReduceSum.apply(t, mesh)


def reduce_sum(mesh, tensors):
    """Sum a list of tensors over the ranks in one all-reduce of one flat
    float32 buffer; returns the summed tensors in their shapes and dtypes."""
    if not collective(mesh) or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    all_reduce_sum(flat, mesh)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(t.shape).to(t.dtype))
        start += t.numel()
    return out


# -- the batch reductions of a step's forward ------------------------------------

_ACTIVE = []


@contextlib.contextmanager
def batch_reductions(mesh):
    """Within this block the forward's batch reductions (the DCN entropy's
    codeword counts, ``percentile_normalize``, the 'shift' brightness) run
    over all ranks of ``mesh``; None or a mesh without a group changes
    nothing."""
    if not collective(mesh):
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active():
    """The mesh of the enclosing :func:`batch_reductions`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None
