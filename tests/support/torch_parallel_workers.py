"""Rank functions of the port's data-parallel tests, run by
``neural_imaging_tpu_torch.parallel.launch.run`` in spawned processes (one
per rank) and, with ``parallel=None``, in the test process as the one-process
reference at the global batch. They import torch and the port only, so that
a rank's process starts without JAX.

Each takes a spec of plain values and numpy arrays (weights as flax paths,
batches as the global batch) and returns tensors on the CPU."""
import numpy as np
import torch

from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.models import base, compression, pipelines
from neural_imaging_tpu_torch.ops.hopper import codebook
from neural_imaging_tpu_torch.parallel import mesh as mesh_lib
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)


def _params(named):
    return {k: p.detach().clone() for k, p in named}


def joint_case(parallel, spec):
    """The joint flow's loss, parts and gradients on the (sharded) global
    batch, then one Adam step; the parameters after it."""
    flow = ManipulationClassification(
        'INet', manipulations=spec['manipulations'], distribution=spec['distribution'],
        fan_args=spec['fan_args'], trainable=spec['trainable'], raw_patch_size=spec['patch'],
        nip_args=spec['nip_args'], device='cpu')
    flow.fan.module.load_state_dict(base.convert_params(spec['fan_flat']), strict=True)
    flow.nip.load_model(spec['nip_dir'], quiet=True)
    flow._snapshot()
    flow.reinitialize()
    bx, by = spec['bx'], spec['by']
    if parallel is not None:
        parallel.distribute(flow)
        bx, by = parallel.shard(bx, by)
    step = flow.loss_and_gradients(bx, by, spec['lambda_nip'], spec['lambda_dcn'])
    with torch.no_grad():
        fan_input = flow._forward(flow._batch(bx).permute(0, 3, 1, 2),
                                  *flow._channel_qtables())[2].permute(0, 2, 3, 1)
    flow.training_step(bx, by, spec['lambda_nip'], spec['lambda_dcn'], learning_rate=1e-4)
    params = {part: _params(leaves.items()) for part, leaves in flow._collect_params().items()}
    return {'step': step, 'params': params, 'fan_input': fan_input}


def dcn_case(parallel, spec):
    """A TwitterDCN step on the (sharded) global batch: its values, the
    summed gradients and the parameters after the update."""
    dcn = compression.TwitterDCN(patch_size=spec['patch'], device='cpu', **spec['args'])
    dcn.module.load_state_dict(base.convert_params(spec['flat']), strict=True)
    dcn.init_optimizer()
    x = spec['x']
    if parallel is not None:
        parallel.distribute(dcn)
        (x,) = parallel.shard(x)
    values = dcn.training_step(x, 1e-4)
    grads = {k: p.grad.detach().clone() for k, p in dcn.module.named_parameters()}
    return {'values': values, 'grads': grads,
            'params': _params(dcn.module.named_parameters())}


def nip_case(parallel, spec):
    """A NIP step (ClassicISP, its brightness as given) on the (sharded)
    global batch: the loss, the summed gradients, the parameters after."""
    model = pipelines.ClassicISP(patch_size=spec['patch'], device='cpu', **spec['args'])
    model.module.load_state_dict(base.convert_params(spec['flat']), strict=False)
    model.init_optimizer()
    bx, by = spec['bx'], spec['by']
    if parallel is not None:
        parallel.distribute(model)
        bx, by = parallel.shard(bx, by)
    grads, step = {}, model.optimizer.step

    def step_and_keep_the_gradients():
        # the step clears .grad after the update: keep the summed gradients
        grads.update({k: p.grad.detach().clone() for k, p in model.module.named_parameters()})
        step()
    model.optimizer.step = step_and_keep_the_gradients
    loss = model.training_step(bx, by, 1e-4)
    return {'loss': loss, 'grads': grads, 'params': _params(model.module.named_parameters())}


def quantizer_case(parallel, spec):
    """``quantize_with_entropy_fused`` on this rank's share of a global
    latent: the entropy, and the gradients of λ·H + Σ q·w (the rank's share:
    λ·H over the rank count) as summed over the ranks, and the entropy of
    the rank's own share alone."""
    z = torch.tensor(spec['z'])
    w = torch.tensor(spec['w'])
    cb = torch.nn.Parameter(torch.tensor(spec['codebook']))
    mesh = None if parallel is None else parallel.mesh
    world = 1 if parallel is None else parallel.n_devices
    if parallel is not None:
        z, w = parallel.shard(z, w)
    local_entropy = codebook.quantize_with_entropy_fused(z, cb.detach(), trainable=False)[1]
    z = z.clone().requires_grad_(True)
    with mesh_lib.batch_reductions(mesh):
        q, h, _ = codebook.quantize_with_entropy_fused(z, cb, trainable=spec['trainable'])
        loss = spec['lambda'] * h / world + torch.sum(q * w)
        dz, dcb = torch.autograd.grad(loss, (z, cb), allow_unused=True)
    if dcb is None:
        dcb = torch.zeros_like(cb)
    (dcb,) = mesh_lib.reduce_sum(mesh, [dcb])
    dz_global = mesh_lib.all_gather_flat(dz, mesh)
    return {'entropy': h.detach(), 'local_entropy': local_entropy, 'dz': dz_global, 'dcb': dcb}


def sampler_case(parallel, spec):
    """Device-sampled batches of a few steps: this rank's rows."""
    data = Dataset(spec['data_dir'], load=spec['load'], n_images=spec['n_images'],
                   v_images=spec['v_images'], val_rgb_patch_size=spec['patch'],
                   val_n_patches=1)
    sampler = DeviceSampler(data, spec['batch'], spec['patch'], device='cpu',
                            parallel=parallel)
    out = []
    for step in range(spec['steps']):
        b = sampler(step)
        # uint16 RAW as int32: a uint16 tensor does not cross processes by pickle
        out.append(tuple(t.to(torch.int32) for t in (b if isinstance(b, tuple) else (b,))))
    return out


def inference_case(parallel, spec):
    """``sharded_inference`` of an INet over the ranks (the batch padded to
    divide), or the one-process ``process``."""
    from neural_imaging_tpu_torch.parallel import train as ptrain
    model = pipelines.INet(device='cpu')
    if parallel is None:
        return model.process(spec['x'])
    return ptrain.sharded_inference(model, spec['x'], parallel.mesh)


def multihost_case(parallel, spec):
    """The multihost helpers on this rank."""
    from neural_imaging_tpu_torch.parallel import multihost

    @multihost.primary_only
    def write():
        return 'written'
    rank = multihost.process_index()
    return {'rank': rank, 'count': multihost.process_count(),
            'primary': multihost.is_primary(), 'write': write(),
            'slice': multihost.local_batch_slice(spec['batch']),
            'mean': multihost.sync_global_value(float(rank)),
            'agreed': multihost.agree(f'rank {rank}'),
            'mesh': multihost.global_mesh('cpu').world_size}


CASES = {'multihost': multihost_case, 'inference': inference_case, 'joint': joint_case, 'dcn': dcn_case, 'nip': nip_case, 'quantizer': quantizer_case,
         'sampler': sampler_case}


def run_cases(parallel, specs):
    """Each (name, kind, spec) of ``specs`` through its case; {name: result}."""
    torch.manual_seed(0)
    return {name: CASES[kind](parallel, spec) for name, kind, spec in specs}



# -- the trainers --------------------------------------------------------------------

def _files_under(root):
    import os
    if not os.path.isdir(root):
        return []
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def nip_trainer_case(parallel, spec, root):
    from neural_imaging_tpu_torch.training.pipeline import train_nip_model
    data = Dataset(spec['data_dir'], **spec['split'])
    model = pipelines.INet(patch_size=spec['patch'], device='cpu')
    train_nip_model(model, 'Cam', n_epochs=spec['epochs'], validation_schedule=1,
                    patch_size=spec['patch'], batch_size=spec['batch'], data=data,
                    out_directory_root=root, device_data=spec['device_data'],
                    parallel=parallel)
    return {'performance': model.performance, 'files': _files_under(root)}


def manipulation_trainer_case(parallel, spec, root):
    from neural_imaging_tpu_torch.training.manipulation import train_manipulation_nip
    data = Dataset(spec['data_dir'], **spec['split'])
    flow = ManipulationClassification(
        'INet', manipulations=['sharpen'], fan_args=spec['fan_args'], trainable={'nip'},
        raw_patch_size=spec['patch'], device='cpu')
    train_manipulation_nip(
        flow, {'camera_name': 'Cam', 'use_pretrained_nip': False, 'patch_size': spec['patch'],
               'batch_size': spec['batch'], 'n_epochs': spec['epochs'],
               'validation_schedule': 1, 'learning_rate': 1e-4, 'lambda_nip': 0.1,
               'lambda_dcn': 0, 'run_number': 0, 'augment': False},
        data, directories={'root': root, 'nip_snapshots': root}, parallel=parallel)
    return {'performance': {'fan': flow.fan.performance, 'nip': flow.nip.performance},
            'files': _files_under(root)}


def dcn_trainer_case(parallel, spec, root):
    from neural_imaging_tpu_torch.training.compression import train_dcn
    data = Dataset(spec['data_dir'], load='y', **spec['split'])
    dcn = compression.TwitterDCN(patch_size=spec['patch'], n_features=4, device='cpu')
    train_dcn(dcn, {'n_epochs': spec['epochs'], 'batch_size': spec['batch'],
                    'patch_size': spec['patch'], 'validation_schedule': 1},
              data, directory=root, rng=np.random.default_rng(spec['seed']),
              device_data=spec['device_data'], parallel=parallel)
    return {'performance': dcn.performance, 'files': _files_under(root)}


TRAINERS = {'nip': nip_trainer_case, 'manipulation': manipulation_trainer_case,
            'dcn': dcn_trainer_case}


def run_trainers(parallel, specs, root):
    """Each (name, trainer, spec) of ``specs`` into ``<root>/<name>/rank<r>``
    (``<root>/<name>/single`` without ``parallel``); {name: result}."""
    import os
    torch.manual_seed(0)
    tag = 'single' if parallel is None else f'rank{parallel.rank}'
    return {name: TRAINERS[kind](parallel, spec, os.path.join(root, name, tag))
            for name, kind, spec in specs}
