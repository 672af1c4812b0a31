"""
The system under test: the port's joint flow
(``neural_imaging_tpu_torch.workflows.manipulation_classification``), built
from a configuration file's ``flow`` section, with the weights that the
benchmark hands it. Nothing else of the port is read here.

A configuration's ``weights`` give each part that holds leaves ('nip', 'fan',
'dcn') either a snapshot, read by the part's reference ``load`` for the
reference while the program reads it its own way, or ``DRAWN``: its leaves
are drawn from the seed at the shapes of its reference ``leaf_shapes``,
copied into the program and handed to the reference. Each part's reference
module comes from the configuration's reference flow (``parts``).
"""
import zlib
from pathlib import Path

import torch

from benchmark.reference import by_name, ops

REPO = Path(__file__).resolve().parents[1]
DRAWN = 'drawn from the seed'


def reference_parts(config):
    """{part: (reference module, arguments of its ``leaf_shapes``)}, found by
    the names in ``config`` (a missing file fails here)."""
    return by_name.flow(config).parts(config)


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


def part_seed(part, seed):
    """The seed of a drawn part's own generator: the run's seed for the FAN,
    for any other part the seed XOR (CRC-32 of the part's name) << 32."""
    return int(seed) if part == 'fan' else int(seed) ^ (zlib.crc32(part.encode()) << 32)


def _needs(module, name, part):
    fn = getattr(module, name, None)
    if fn is None:
        raise RuntimeError(f"{module.__name__} gives no {name}(), which the part {part!r} "
                           f"needs as the configuration's weights have it")
    return fn


def drawn_leaves(config, seed, device):
    """{'<part>/<name>': tensor} of every part whose ``weights`` entry is
    ``DRAWN``, drawn on ``device`` by its reference's ``draw`` (the FAN's:
    ``reference.fan.draw``) or else ``reference.ops.lecun_draw``, on a
    generator seeded by ``part_seed``."""
    leaves = {}
    for part, (module, args) in reference_parts(config).items():
        if config.get('weights', {}).get(part) != DRAWN:
            continue
        gen = torch.Generator(device=device).manual_seed(part_seed(part, seed))
        shapes = _needs(module, 'leaf_shapes', part)(**args)
        draw = getattr(module, 'draw', ops.lecun_draw)
        leaves.update({f'{part}/{k}': v for k, v in draw(shapes, gen, device).items()})
    return leaves


def snapshot_leaves(config, device):
    """{'<part>/<name>': tensor} of every part whose ``weights`` entry is a
    snapshot, read by its reference's ``load``."""
    leaves = {}
    for part, (module, _) in reference_parts(config).items():
        path = config.get('weights', {}).get(part)
        if path and path != DRAWN:
            leaves.update({f'{part}/{k}': v for k, v in
                           _needs(module, 'load', part)(REPO / path, device).items()})
    return leaves


def build(config, seed, device):
    """(flow, the leaves handed to it {'<part>/<name>': tensor}): the drawn
    parts' leaves (``drawn_leaves``), checked by name and shape against the
    program's parameters and copied into them; the ISP and the codec load
    the snapshots that the configuration names."""
    parts = reference_parts(config)
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
    params = leaves_of(flow, parts)
    unnamed = {k.split('/')[0] for k in params} - set(config.get('weights', {}))
    if unnamed:
        raise RuntimeError(f"the configuration's weights name nothing for {sorted(unnamed)}, "
                           f'which hold leaves: name a snapshot, or {DRAWN!r}')
    drawn = drawn_leaves(config, seed, device)
    for part in {k.split('/')[0] for k in drawn}:
        theirs = {k: tuple(p.shape) for k, p in params.items() if k.startswith(part + '/')}
        ours = {k: tuple(v.shape) for k, v in drawn.items() if k.startswith(part + '/')}
        if theirs != ours:
            raise RuntimeError(f'{part} leaves {sorted(theirs.items())} differ from the '
                               f'drawn {sorted(ours.items())}')
    with torch.no_grad():
        for name, value in drawn.items():
            params[name].copy_(value)
    return flow, drawn
