#!/usr/bin/env python3
"""
Where one request of the PyTorch port's manipulation-classification forward
path spends its time on the GPU: the stream time of each stage (CUDA events
around INet, the manipulations, pooling, the JPEG channel and the FAN,
composed as ``ManipulationClassification._forward`` composes them, with a
synchronize between stages, so kernels plus any gaps while the host
enqueues), the request's wall time, and, from ``torch.profiler``, the GPU
kernels' own time, the device's busy share over a profiled window, and the
kernels that take the most time (``device_profile``, which
``profile_torch_dcn.py`` uses too).

``--train`` does the same for one joint training step of the same run with
the NIP trainable (λ_nip 0.1, as ``chip_smoke.py`` runs it): the stream time
of each stage's forward and of its backward (each stage's VJP taken alone
with ``torch.autograd.grad``, in reverse order), the loss, and the Adam
update; the step's wall time; and the device profile of whole steps.

    python3 profile_torch_slice.py [--seed 0] [--batch 20] [--requests 10] [--train]

Needs a CUDA device. Prints one JSON line last.
"""
import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (RAW_PATCH, RUN_DIR, TRAIN_LAMBDA_NIP, synthetic_raw,
                        training_batches)
from neural_imaging_tpu_torch.models import forensics
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)


def stage_times(flow, x, reps):
    """Median stream ms of each stage of the forward path over ``reps`` runs."""
    stages = {
        'inet': lambda t: flow.nip.module(t),
        'manipulations': flow._manipulate,
        'pool': flow._downsample,
        'jpeg channel': lambda t: flow._compress(t, *flow._channel_qtables()),
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


class _Timer:
    """Stream ms of named calls, each between CUDA events and synchronized."""

    def __init__(self):
        self.times = {}

    def __call__(self, name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.times.setdefault(name, []).append(start.elapsed_time(end))
        return out

    def medians(self):
        return {name: float(np.median(v)) for name, v in self.times.items()}


def train_stage_times(flow, x, y, lambda_nip, reps):
    """Median stream ms of each stage of a training step, forward and
    backward, over ``reps`` steps: each stage runs on a detached copy of its
    input, so its backward is its own VJP."""
    timer = _Timer()
    q = flow._channel_qtables()
    labels = flow._batch_labels(x.shape[0])
    nip_params = list(flow.nip.module.parameters())
    fan_params = list(flow.fan.module.parameters())
    grad = torch.autograd.grad

    def leaf(t):
        return t.detach().requires_grad_()

    for _ in range(reps):
        Y = timer('inet fwd', lambda: flow.nip.module(x))
        Yd = leaf(Y)
        m = timer('manipulations fwd', lambda: flow._manipulate(Yd))
        md = leaf(m)
        c = timer('pool fwd', lambda: flow._downsample(md))
        cd = leaf(c)
        C = timer('jpeg channel fwd (K1)', lambda: flow._compress(cd, *q))
        Cd = leaf(C)
        p = timer('fan fwd', lambda: flow.fan.module(Cd))
        loss = timer('loss fwd', lambda: forensics.sparse_categorical_crossentropy(labels, p)
                     + lambda_nip * flow.nip.loss(y, Yd.permute(0, 2, 3, 1)))
        g_p, g_Y_loss = timer('loss bwd', lambda: grad(loss, [p, Yd]))
        g_C, *g_fan = timer('fan bwd', lambda: grad(p, [Cd] + fan_params, g_p))
        g_c, = timer('jpeg channel bwd (plain)', lambda: grad(C, [cd], g_C))
        g_m, = timer('pool bwd', lambda: grad(c, [md], g_c))
        g_Y, = timer('manipulations bwd', lambda: grad(m, [Yd], g_m))
        g_nip = timer('inet bwd', lambda: grad(Y, nip_params, g_Y + g_Y_loss))

        def adam():
            for param, g in zip(nip_params + fan_params, list(g_nip) + g_fan):
                param.grad = g
            flow.optimizer.step()
            flow.optimizer.zero_grad(set_to_none=True)
        timer('adam', adam)
    return timer.medians()


def train(args):
    """The --train mode: stage times, step wall time and device profile."""
    flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, trainable={'nip'},
                                              device='cuda')
    flow.nan_check = False
    (bx, by), = training_batches(args.seed, 1, args.batch)
    for _ in range(3):
        flow.training_step(bx, by, TRAIN_LAMBDA_NIP)
    torch.cuda.synchronize()
    stages = train_stage_times(flow, bx.permute(0, 3, 1, 2).contiguous(), by, TRAIN_LAMBDA_NIP,
                               args.requests)
    for name, ms in stages.items():
        print(f'[train stage] {name:26s} {ms:8.3f} ms stream', flush=True)
    walls = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        flow.training_step(bx, by, TRAIN_LAMBDA_NIP)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f'[train step] median wall {1e3 * float(np.median(walls)):.3f} ms', flush=True)
    p = device_profile(lambda: flow.training_step(bx, by, TRAIN_LAMBDA_NIP), args.requests,
                       n_top=20, match=('jpeg8x8',))
    print_profile('train step', p)
    flow.assert_finite()
    return {'device': torch.cuda.get_device_name(0), 'batch': args.batch,
            'step_wall_ms_median': 1e3 * float(np.median(walls)),
            'stage_stream_ms': stages, 'stage_stream_ms_sum': sum(stages.values()), **p}


def device_profile(fn, reps, n_top=12, match=()):
    """Run ``fn`` ``reps`` times under torch.profiler; device ms per call,
    busy share of the window, device operations per call, the ``n_top``
    kernels that take the most time, and the ms per call of the kernels whose
    names hold a string of ``match``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side events only (host ops also carry the device time of the
    # kernels they launch), without user annotations such as Optimizer.step,
    # whose device-track spans cover kernels that are counted themselves
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    device_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{'kernel': e.key[:90], 'calls_per_call': e.count / reps,
            'ms_per_call': e.self_device_time_total / 1e3 / reps} for e in events[:n_top]]
    matched_ms = sum(e.self_device_time_total for e in events
                     if any(m in e.key for m in match)) / 1e3 / reps
    return {'profiled_wall_ms_per_call': 1e3 * window / reps,
            'device_ms_per_call': device_us / 1e3 / reps,
            'device_busy_share': device_us / 1e6 / window,
            'device_ops_per_call': sum(e.count for e in events) / reps,
            'matched_kernels_ms_per_call': matched_ms, 'top_kernels': top}


def print_profile(label, p):
    print(f'[{label}] device {p["device_ms_per_call"]:.3f} ms of '
          f'{p["profiled_wall_ms_per_call"]:.3f} ms wall per call, busy '
          f'{100 * p["device_busy_share"]:.1f}%, {p["device_ops_per_call"]:.0f} device ops, '
          f'matched kernels {p["matched_kernels_ms_per_call"]:.4f} ms', flush=True)
    for row in p['top_kernels']:
        print(f"[{label}]   {row['ms_per_call']:8.3f} ms x{row['calls_per_call']:5.1f} "
              f"{row['kernel']}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch', type=int, default=20)
    parser.add_argument('--requests', type=int, default=10)
    parser.add_argument('--train', action='store_true',
                        help='profile a training step instead of a request')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_slice: needs a CUDA device')
    if args.train:
        print(json.dumps(train(args)))
        return

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

    def request():
        flow.run_workflow_to_decisions(raw)
    p = device_profile(request, args.requests, n_top=15)
    print_profile('request', p)
    result = {
        'device': torch.cuda.get_device_name(0), 'batch': args.batch,
        'request_wall_ms_median': 1e3 * float(np.median(walls)),
        'stage_stream_ms': stages, 'stage_stream_ms_sum': sum(stages.values()), **p,
    }
    print(json.dumps(result))


if __name__ == '__main__':
    main()
