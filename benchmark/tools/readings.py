#!/usr/bin/env python3
"""
The upper readings of a cell's numbers: the plain reference put in the
program's place, computed in TF32 (the precision below the float32 that the
configurations state: the control), and with each planted fault (half of
each training batch left out, the mean taken over the rest; the first row's
answer altered where the FAN produces it), each held against the float32
reference exactly as ``run.py`` holds the program: with a learned codec,
the float32 reference is run again on the codewords that side chose.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 [--program]

Needs a CUDA device (TF32 exists only there); prints one JSON line a seed.
Runs no program code: the inputs and weights come from the benchmark alone.
With ``--program`` it gives the lower readings instead: a short run of the
cell a seed, all in this process (the window cut to ``PROGRAM_SECONDS``, a
classification cell's sample drawn from its first calls), the program
against the float32 reference exactly as ``run.py`` holds it.
"""
import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import generator, judge, run, system  # noqa: E402
from benchmark.entries import training_step  # noqa: E402
from benchmark.reference import ops  # noqa: E402

PROGRAM_SECONDS = 0.6
PROGRAM_SAMPLE = {'workload': {'judge': {'sample': 12, 'sample_from': 12}}}


def state_of(workload, seed, device, overrides=None):
    """What an entry's reference side reads, made without the program."""
    _, _, spec, config = run.cell(workload)
    spec = run.merge(spec, (overrides or {}).get('workload'))
    config = run.merge(config, (overrides or {}).get('config'))
    s = training_step.State()
    s.config, s.workload, s.device = config, spec, device
    s.handed = system.drawn_leaves(config, seed, device)
    s.pool = generator.make_pool(spec['traffic'], seed, device)
    if spec['entry'] == 'training_step':
        leaves = training_step.reference_leaves(config, s.handed, device)
        s.start = {k: v for k, v in leaves.items()
                   if k.split('/')[0] in {'fan', *config['flow'].get('trainable', ())}}
    else:
        rules = spec['judge']
        rng = np.random.default_rng(int(seed))
        sampled = sorted(rng.choice(rules['sample_from'], rules['sample'], replace=False).tolist())
        s.kept = dict.fromkeys(sampled)
    return spec, s


def judged(entry, s, side, ref):
    """``side``'s numbers against the float32 reference ``ref``, or, where
    ``side`` kept a learned codec's codewords, against the float32 reference
    run again on them, as ``run.py`` runs it on the program's."""
    if isinstance(side, dict) and side.get('codes'):
        s.codes = side['codes']
        with ops.precision(False):
            ref = entry.reference_side(s)
        s.codes = None
    return entry.numbers(side, ref)


def readings(workload, seed, device, overrides=None):
    spec, s = state_of(workload, seed, device, overrides)
    entry = importlib.import_module(f"benchmark.entries.{spec['entry']}")
    out = {'workload': workload, 'seed': seed}
    t0 = time.perf_counter()
    with ops.precision(False):
        ref = entry.reference_side(s)
    out['reference_s'] = time.perf_counter() - t0
    with ops.precision(True):
        control = entry.reference_side(s)
    out['tf32'] = judged(entry, s, control, ref)
    faults = ('half_batch', 'answer') if spec['entry'] == 'training_step' else ('answer',)
    for fault in faults:
        with ops.precision(False):
            side = entry.reference_side(s, fault)
        out[fault] = judged(entry, s, side, ref)
    out['limits'] = spec['limits']
    out['control_fails'] = not judge.verdict(out['tf32'], spec['limits'])[1]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True, help='comma-separated')
    p.add_argument('--program', action='store_true', help='the lower readings')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('the control needs a CUDA device', file=sys.stderr)
        return 2
    for seed in (int(x) for x in args.seeds.split(',')):
        if args.program:
            _, _, spec, _ = run.cell(args.workload)
            keep = {}
            result = run.run(args.workload, seed, PROGRAM_SECONDS, 0, 'cuda',
                             overrides=PROGRAM_SAMPLE if 'judge' in spec else None, keep=keep)
            out = {'workload': args.workload, 'seed': seed, 'correct': result['correct'],
                   'program': {k: v for k, v in keep['numbers'].items()
                               if k in spec['limits'] or isinstance(v, (float, list))}}
        else:
            out = readings(args.workload, seed, torch.device('cuda'))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
