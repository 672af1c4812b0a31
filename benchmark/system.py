"""
The system under test: the port's joint flow
(``neural_imaging_tpu_torch.workflows.manipulation_classification``), built
from a configuration file's ``flow`` section, with the weights that the
benchmark hands it. Nothing else of the port is read here.
"""
from pathlib import Path

import torch

from benchmark.reference import fan as fan_ref

REPO = Path(__file__).resolve().parents[1]


def leaves_of(flow, parts):
    """{'<part>/<name>': parameter} of the flow's parts ('nip', 'fan', 'dcn')."""
    modules = {'nip': flow.nip.module, 'fan': flow.fan.module}
    if flow.codec is not None and hasattr(flow.codec, 'module') and flow.codec.module is not None:
        modules['dcn'] = flow.codec.module
    return {f'{part}/{name}': p for part in parts if part in modules
            for name, p in modules[part].named_parameters()}


def module_at(flow, path):
    """The flow's module at a dotted attribute path ('codec.module.decoder')."""
    obj = flow
    for part in path.split('.'):
        obj = getattr(obj, part)
    return obj


def fan_leaves(config, seed, device):
    """The FAN's leaves drawn from ``seed`` on ``device`` (``reference.fan.draw``)."""
    spec = config['flow']
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return fan_ref.draw(fan_ref.leaf_shapes(len(spec['manipulations']) + 1, **spec['fan_args']),
                        gen, device)


def build(config, seed, device):
    """(flow, the leaves handed to it {'<part>/<name>': tensor}). The FAN's
    leaves are drawn from ``seed`` on ``device`` (``reference.fan.draw``);
    the ISP and the codec load the snapshots that the configuration names."""
    from neural_imaging_tpu_torch.workflows.manipulation_classification import (
        ManipulationClassification)
    spec = config['flow']
    nip = spec['nip']
    if spec.get('nip_snapshot'):
        nip = f"{nip}:{REPO / spec['nip_snapshot']}"
    flow = ManipulationClassification(
        nip, manipulations=spec['manipulations'], distribution=spec['distribution'],
        fan_args=spec['fan_args'], trainable=set(spec.get('trainable', ())),
        raw_patch_size=spec['raw_patch_size'], nip_args=spec.get('nip_args'), rng_seed=0,
        device=device)
    flow.nan_check = False
    drawn = fan_leaves(config, seed, device)
    fan_params = dict(flow.fan.module.named_parameters())
    if set(fan_params) != set(drawn):
        raise RuntimeError(f'FAN leaves {sorted(fan_params)} differ from {sorted(drawn)}')
    with torch.no_grad():
        for name, value in drawn.items():
            fan_params[name].copy_(value)
    handed = {f'fan/{k}': v for k, v in drawn.items()}
    return flow, handed
