#!/usr/bin/env python3
"""
Where one request of the PyTorch port's manipulation-classification forward
path spends its time on the GPU: the stream time of each stage (CUDA events
around INet, the manipulations, pooling, the JPEG channel and the FAN,
composed as ``ManipulationClassification._forward`` composes them, with a
synchronize between stages, so kernels plus any gaps while the host
enqueues), the request's wall time, and, from ``torch.profiler``, the GPU
kernels' own time, the device's busy share over a profiled window, and the
kernels that take the most time.

    python3 profile_torch_slice.py [--seed 0] [--batch 20] [--requests 10]

Needs a CUDA device. Prints one JSON line last.
"""
import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import RAW_PATCH, RUN_DIR, synthetic_raw
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)


def stage_times(flow, x, reps):
    """Median stream ms of each stage of the forward path over ``reps`` runs."""
    stages = {
        'inet': lambda t: flow.nip.module(t),
        'manipulations': flow._manipulate,
        'pool': flow._downsample,
        'jpeg channel': flow._compress,
        'fan': lambda t: flow.fan.module(t),
    }
    times = {name: [] for name in stages}
    with torch.no_grad():
        for _ in range(reps):
            t = x
            for name, stage in stages.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t = stage(t)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
    return {name: float(np.median(v)) for name, v in times.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch', type=int, default=20)
    parser.add_argument('--requests', type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_slice: needs a CUDA device')

    flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, device='cuda')
    raw = synthetic_raw(args.seed, args.batch, RAW_PATCH)
    for _ in range(3):
        flow.run_workflow_to_decisions(raw)
    torch.cuda.synchronize()

    x = torch.as_tensor(raw, device='cuda').permute(0, 3, 1, 2).contiguous()
    stages = stage_times(flow, x, args.requests)
    for name, ms in stages.items():
        print(f'[stage] {name:14s} {ms:8.3f} ms stream', flush=True)

    walls = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        flow.run_workflow_to_decisions(raw)
        walls.append(time.perf_counter() - t0)
    print(f'[request] median wall {1e3 * float(np.median(walls)):.3f} ms', flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            flow.run_workflow_to_decisions(raw)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side events only (kernels, copies): host ops also carry the
    # device time of the kernels they launch
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{'kernel': e.key[:90], 'calls_per_request': e.count / args.requests,
            'ms_per_request': e.self_device_time_total / 1e3 / args.requests}
           for e in events[:15]]

    for row in top:
        print(f"[kernel] {row['ms_per_request']:8.3f} ms x{row['calls_per_request']:5.1f} "
              f"{row['kernel']}")
    result = {
        'device': torch.cuda.get_device_name(0), 'batch': args.batch,
        'request_wall_ms_median': 1e3 * float(np.median(walls)),
        'stage_stream_ms': stages, 'stage_stream_ms_sum': sum(stages.values()),
        'profiled_wall_ms_per_request': 1e3 * window / args.requests,
        'device_ms_per_request': device_us / 1e3 / args.requests,
        'device_busy_share': device_us / 1e6 / window,
        'kernels_per_request': sum(e.count for e in events) / args.requests,
        'top_kernels': top,
    }
    print(json.dumps(result))


if __name__ == '__main__':
    main()
