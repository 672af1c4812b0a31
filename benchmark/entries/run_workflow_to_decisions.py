"""
Entry: ``ManipulationClassification.run_workflow_to_decisions``, one client
in a closed loop, each request a batch handed over as host numpy arrays,
cycled from the traffic's pool.

For a sample of the window's requests, drawn from the seed among the first
``sample_from`` (``judge`` in the workload file), forward hooks that the
benchmark puts on the program's modules keep what the timed path produced:
the developed RGB (the ISP module's output), the quantized latent (the
codec decoder's input), the channel's output and the probabilities (the
FAN module's input and output). After the window the reference recomputes
those requests.
"""
import time

import numpy as np
import torch

from benchmark import generator, judge, system
from benchmark.entries.training_step import reference


class State:
    pass


def kept_keys(config):
    """What a sampled request keeps: 'Y' where the ISP computes (its
    reference is no ``IDENTITY``), 'q' with a learned codec, and always 'C'
    and 'probs'."""
    keys = ['C', 'probs']
    if not getattr(system.reference_parts(config)['nip'][0], 'IDENTITY', False):
        keys.append('Y')
    if config['flow']['distribution']['compression'] == 'dcn':
        keys.append('q')
    return keys


def setup(config, workload, seed, device, tamper=None):
    s = State()
    s.config, s.workload, s.device = config, workload, device
    t = [time.perf_counter()]
    s.flow, s.handed = system.build(config, seed, device)
    t.append(time.perf_counter())
    s.pool = generator.make_pool(workload['traffic'], seed, device)
    t.append(time.perf_counter())
    s.samples = workload['traffic']['batch']
    rules = workload['judge']
    rng = np.random.default_rng(int(seed))
    # the first warm-up calls are numbered below zero: none is sampled
    s.sampled = set(rng.choice(rules['sample_from'], rules['sample'], replace=False).tolist())
    s.next = -workload['warmup_calls']
    s.kept = {}
    if tamper is not None:
        tamper(s.flow)
    s.hooks = []
    keys = kept_keys(config)
    if 'Y' in keys:
        s.hooks.append(s.flow.nip.module.register_forward_hook(
            lambda m, args, out: _keep(s, 'Y', out)))
    if 'q' in keys:
        s.hooks.append(system.module_at(s.flow, 'codec.module.decoder').register_forward_pre_hook(
            lambda m, args: _keep(s, 'q', args[0])))

    def keep_fan(module, args, out):
        _keep(s, 'C', args[0])
        _keep(s, 'probs', out)
    s.hooks.append(s.flow.fan.module.register_forward_hook(keep_fan))
    for _ in range(workload['warmup_calls']):
        call(s)
    t.append(time.perf_counter())
    s.phases = dict(zip(('build', 'inputs', 'warmup'), (b - a for a, b in zip(t, t[1:]))))
    return s


def _keep(s, key, tensor):
    """Keep ``tensor`` of a sampled call (returns None: the hook leaves the
    module's result as it is)."""
    if s.current in s.sampled:
        s.kept.setdefault(s.current, {})[key] = tensor.detach()


def call(s):
    s.current = s.next
    x, _ = s.pool[s.next % len(s.pool)]
    s.next += 1
    return s.flow.run_workflow_to_decisions(x)


def close(s):
    for h in s.hooks:
        h.remove()
    return 0


def program_side(s):
    return [s.kept[i] for i in sorted(s.kept)]


def reference_side(s, fault=None):
    ref = reference(s.config, s.handed, s.device, fault)
    out = []
    with torch.no_grad():
        for i in sorted(s.kept):
            r = ref.forward(generator.nchw(s.pool[i % len(s.pool)][0], s.device))
            out.append({k: r[k] for k in kept_keys(s.config)})
    return out


def free(s):
    s.flow = None


def numbers(prog, ref):
    return judge.classify_numbers(prog, ref)


def reference_call(s):
    """One reference request at the cell's shapes, for the FLOP count."""
    ref = reference(s.config, s.handed, s.device)
    with torch.no_grad():
        ref.forward(generator.nchw(s.pool[0][0], s.device))
