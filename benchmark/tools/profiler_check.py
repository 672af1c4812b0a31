#!/usr/bin/env python3
"""
Cross-check of the profiler's kernel times, which ``hand_kernel_roofline``
reads: K1's launches in a traced run of ``m_quality-train`` (the
manipulation's P=60 256² and the channel's P=300 128², alternating), against
CUDA-event timing of the same launches in the same process, queued behind
a device-side spin so that no host time falls inside the events.

    python3 benchmark/tools/profiler_check.py [--seed 11] [--seconds 3]

Prints one JSON line: each shape's profiler mean and event mean in ms.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.reference import jpeg as jpeg_ref  # noqa: E402

SHAPES = ((60, 256, 256), (300, 128, 128))      # the order a step launches them in
REPS = 50


def event_ms(launch, reps=REPS):
    """Device ms a launch: ``reps`` launches queued behind a spin, between two events."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    queued_ahead = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps, queued_ahead


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--seed', type=int, default=11)
    p.add_argument('--seconds', type=float, default=3.0)
    args = p.parse_args(argv)
    keep = {}
    run.run('m_quality-train', args.seed, args.seconds, 1, 'cuda', keep=keep)
    k1 = [op['end'] - op['start'] for op in keep['ctx'].trace.ops if 'jpeg8x8' in op['name']]
    out = {'traced_k1_launches': len(k1)}
    from neural_imaging_tpu_torch.ops.hopper import jpeg8x8
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    for i, (p_, h, w) in enumerate(SHAPES):
        planes = torch.rand((p_, h, w), generator=gen, device='cuda') * 255 - 127
        q = torch.stack([torch.as_tensor(jpeg_ref.qtable(50, c == 0), device='cuda')
                         for c in (0, 1, 1)]).repeat(p_ // 3, 1, 1).contiguous()
        ms, queued = event_ms(lambda: jpeg8x8.jpeg_core_cuda(planes, q))
        out[f'{p_}x{h}x{w}'] = {'profiler_ms': float(np.mean(k1[i::2])) / 1e6,
                                'event_ms': ms, 'events_queued_ahead': queued}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
