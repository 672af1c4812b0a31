#!/usr/bin/env python3
"""
Device time of K1, the fused dJPEG core (``jpeg8x8_forward``,
``neural_imaging_tpu_torch/csrc/jpeg8x8.cu``), of this tree against that of
another tree (``--baseline``: a directory that holds another
``neural_imaging_tpu_torch/``, for example a commit unpacked by ``git
archive``), on one GPU, at every shape the port's paths launch K1 at and at
ragged edge shapes:

- P=60 256x256 and P=300 128x128: the m_quality request's and step's two
  launches (manipulation jpeg:80, channel QF 50);
- P=480 128x128: the 8-class flow's channel;
- P=30 128x128: the DCN flow's jpeg:80, and the UNet/DNet steps'
  manipulation;
- P=150 64x64: the UNet/DNet steps' channel;
- P=12 256x384: ``test_jpeg``'s 512x768 images (codec evaluation);
- P=30 256x256 and P=150 128x128: the trainer's two at batch 10;
- edges: P=1 8x8, P=3 64x136, P=3 48x392, P=3 8x4288 and P=3 2848x4288
  (the Nikon D90's whole image).

Both trees' kernels are built from their own sources and called through
their own wrappers on the same inputs (``chip_smoke.k1_inputs``, QF 50).
Their outputs are compared bit for bit, and each is held against the plain
version by ``jpeg8x8.check_cores``. Then, in each of ``--rounds`` rounds,
they are timed in turns (baseline, this tree, this tree, baseline), each
time the median of ``--reps`` launches as ``chip_smoke.time_ms`` takes it
(the device's time alone, L2 flushed), and each launch apart by
``torch.profiler`` (``chip_smoke.kernel_ms``). Beside them, two yardsticks
timed the same way: ``copy_ms``, a float32 → float64 copy of the planes (one
kernel that reads 4 and writes 8 bytes a pixel, K1's traffic: the rate the
card delivers), and ``empty_ms``, a launch that does nothing
(``torch.cuda._sleep(0)``). Neither computes K1's function. Bounds from
``chip_smoke.k1_bound``. ``--plans 32:2,40:8`` also times this
tree's kernel with ``launch_plan`` sized for that many resident warps an SM
(the kernel's own residency is the CUDA runtime's, printed first) and at most
that many groups of 4 tiles a warp.

    python3 bench_jpeg8x8.py --baseline DIR [--rounds 3] [--reps 20] [--seed 0]

Needs a CUDA device. Prints one JSON line last.
"""
import argparse
import ctypes
import functools
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from neural_imaging_tpu_torch.ops.hopper import _build, jpeg8x8

SHAPES = ((60, 256, 256), (300, 128, 128), (480, 128, 128), (30, 128, 128), (150, 64, 64),
          (12, 256, 384), (30, 256, 256), (150, 128, 128), *chip_smoke.K1_EDGE_SHAPES)


def load_baseline(root):
    """The K1 wrapper module of the tree at ``root``, bound to a library built
    from that tree's ``csrc/jpeg8x8.cu``."""
    package = Path(root) / 'neural_imaging_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        'baseline_jpeg8x8', package / 'ops/hopper/jpeg8x8.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    path = _build.build([jpeg8x8.LIBRARY], csrc_dir=package / 'csrc')[jpeg8x8.LIBRARY]
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(path))   # what its _launcher() binds
    try:
        module._launcher()
    finally:
        _build.load = load
    return module


def with_plan(resident_warps, max_groups, planes, q):
    """This tree's K1 launched with ``launch_plan`` sized for
    ``resident_warps`` warps an SM and at most ``max_groups`` groups a warp."""
    residency, cap = jpeg8x8._residency, jpeg8x8.MAX_GROUPS_PER_WARP
    sms = residency(planes.device.index or 0)['sms']
    jpeg8x8._residency = lambda index: {'sms': sms, 'resident_warps': resident_warps}
    jpeg8x8.MAX_GROUPS_PER_WARP = max_groups
    try:
        return jpeg8x8.jpeg_core_cuda(planes, q)
    finally:
        jpeg8x8._residency, jpeg8x8.MAX_GROUPS_PER_WARP = residency, cap


def same_bits(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--baseline', required=True)
    parser.add_argument('--rounds', type=int, default=3)
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--plans', default='',
                        help='extra launch plans to time, comma-separated '
                             'RESIDENT_WARPS:MAX_GROUPS pairs')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_jpeg8x8: needs a CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    device = torch.device('cuda')
    baseline = load_baseline(args.baseline)
    build_log = _build.library_path(jpeg8x8.LIBRARY).with_suffix('.log')
    if build_log.exists():
        print('[build] ' + build_log.read_text().strip().replace('\n', '\n[build] '), flush=True)
    residency = jpeg8x8._residency(0)
    print(f'[residency] {residency}', flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    plans = [tuple(int(n) for n in v.split(':')) for v in args.plans.split(',') if v]
    results = []
    for p, h, w in SHAPES:
        planes, q = chip_smoke.k1_inputs(p, h, w, 50, gen, device)
        calls = {'baseline': lambda: baseline.jpeg_core_cuda(planes, q),
                 'this': lambda: jpeg8x8.jpeg_core_cuda(planes, q)}
        for warps, cap in plans:
            calls[f'this_{warps}:{cap}'] = functools.partial(with_plan, warps, cap, planes, q)
        bound_ms, bound_by = chip_smoke.k1_bound(planes.shape)
        record = {'P': p, 'H': h, 'W': w, 'plan': jpeg8x8.launch_plan(p, h, w, **residency),
                  'bound_ms': bound_ms, 'bound_by': bound_by}
        with torch.no_grad():
            outputs = {name: call() for name, call in calls.items()}
            plain = jpeg8x8.jpeg_core_plain(planes, q)
            torch.cuda.synchronize()
            record['bit_identical'] = all(same_bits(outputs['baseline'], out)
                                          for out in outputs.values())
            record['agreement'] = {name: jpeg8x8.check_cores(*out, *plain, q)
                                   for name, out in outputs.items()}
            if not record['bit_identical']:
                record['agreement']['this_vs_baseline'] = jpeg8x8.check_cores(
                    *outputs['this'], *outputs['baseline'], q)
            del outputs, plain
            times = {name: [] for name in calls}
            for _ in range(args.rounds):
                for name in ('baseline', 'this', 'this', 'baseline'):
                    times[name].append(chip_smoke.time_ms(calls[name], args.reps, flush))
                for name in calls:
                    if name not in ('baseline', 'this'):
                        times[name].append(chip_smoke.time_ms(calls[name], args.reps, flush))
            for name in calls:
                record[f'{name}_ms'] = times[name]
                record[f'{name}_median_ms'] = float(np.median(times[name]))
                record[f'{name}_share_of_bound'] = (record['bound_ms']
                                                    / record[f'{name}_median_ms'])
                record[f'{name}_launch_ms'] = chip_smoke.kernel_ms(calls[name], args.reps, flush)
            record['copy_ms'] = chip_smoke.copy_ms(planes, args.reps, flush)
            record['empty_ms'] = chip_smoke.time_ms(lambda: torch.cuda._sleep(0), args.reps, flush)
        record['speedup'] = record['baseline_median_ms'] / record['this_median_ms']
        extra = ''.join(f', {name} {record[f"{name}_median_ms"]:.4f}' for name in calls
                        if name not in ('baseline', 'this'))
        spread = {name: f'{min(times[name]):.4f}-{max(times[name]):.4f}' for name in times}
        print(f'[P={p} {h}x{w}] plan {record["plan"]}; bits '
              f'{"identical" if record["bit_identical"] else "DIFFER"}; baseline '
              f'{record["baseline_median_ms"]:.4f} ms '
              f'({100 * record["baseline_share_of_bound"]:.1f}% of bound) {spread["baseline"]}, '
              f'this tree {record["this_median_ms"]:.4f} ms '
              f'({100 * record["this_share_of_bound"]:.1f}%) {spread["this"]}, '
              f'x{record["speedup"]:.2f}{extra}; copy {record["copy_ms"]:.4f} ms, empty launch '
              f'{record["empty_ms"]:.4f} ms, bound {record["bound_ms"]:.4f} ms '
              f'({record["bound_by"]}); launches baseline '
              f'{chip_smoke.format_launches(record["baseline_launch_ms"])}, this '
              f'{chip_smoke.format_launches(record["this_launch_ms"])}', flush=True)
        results.append(record)
        del planes, q
        torch.cuda.empty_cache()
    print(json.dumps({'device': torch.cuda.get_device_name(0), 'nvidia_smi': smi,
                      'rounds': args.rounds, 'reps': args.reps, 'shapes': results}))


if __name__ == '__main__':
    main()
