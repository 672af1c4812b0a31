#!/usr/bin/env python3
"""
Where one request of the PyTorch port's manipulation-classification forward
path spends its time on the GPU: the stream time of each stage (CUDA events
around INet, the manipulations, pooling, the JPEG channel and the FAN,
composed as ``ManipulationClassification._forward`` composes them, with a
synchronize between stages, so kernels plus any gaps while the host
enqueues), the request's wall time, and, from ``torch.profiler``, the GPU
kernels' own time, the device's busy share over a profiled window, and the
kernels that take the most time (``chip_smoke.device_profile``).

``--train`` does the same for one joint training step of the same run with
the NIP trainable (λ_nip 0.1, as ``chip_smoke.py`` runs it): the stream time
of each stage's forward and of its backward (each stage's VJP taken alone
with ``torch.autograd.grad``, in reverse order), the loss, and the Adam
update; the step's wall time; and the device profile of whole steps. With
``--bf16`` the step is bench.py's configuration instead (every bfloat16
knob, ``chip_smoke.bench_flow``), whose JPEG channel is the bfloat16 plane
form, not K1; with ``--nip UNet`` or ``--nip DNet`` it is the joint step of
that NIP's λ-sweep run (``chip_smoke.nip_flow``: batch 10 raw 64-px
patches, λ_nip 0.005).

``--trainer`` splits the trainer's costs (``chip_smoke.py``'s trainer
configuration, batch 10): the host's sampling of a quantized batch and its
copy, what the host spends queuing a step against the step's wall and
device time, a device-resident draw and step, an epoch of 4 steps fed by
the prefetcher, fed inline and device-resident, and a validation point's
parts (the FAN's validation, the NIP's on the card and its host metrics,
the log and snapshots).

    python3 profile_torch_slice.py [--seed 0] [--batch 20] [--requests 10] [--train [--bf16 | --nip UNet|DNet] | --trainer]

Needs a CUDA device. Prints one JSON line last.
"""
import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (NIP_FLOW_BATCH, NIP_FLOW_LAMBDA, NIP_RAW_PATCH, RAW_PATCH, RUN_DIR,
                        TRAIN_LAMBDA_NIP, TRAIN_LR, TRAINER_BATCH, TRAINER_IMAGES, TRAINER_SIZE,
                        TRAINER_SPLIT, bench_flow, device_profile, nip_flow, print_profile,
                        synthetic_raw, trainer_flow, training_batches)
from neural_imaging_tpu_torch.data import fixtures
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.data.prefetch import EpochPrefetcher, to_device
from neural_imaging_tpu_torch.models import base, forensics
from neural_imaging_tpu_torch.training import validation
from neural_imaging_tpu_torch.utils import metrics
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)


def stage_times(flow, x, reps):
    """Median stream ms of each stage of the forward path over ``reps`` runs."""
    stages = {
        'inet': lambda t: flow.nip.module(t),
        'manipulations': flow._manipulate,
        'pool': flow._downsample,
        'jpeg channel': lambda t: flow._compress(t, *flow._channel_qtables())[0],
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

    nip = flow.nip.scoped_name
    for _ in range(reps):
        Y = timer(f'{nip} fwd', lambda: flow.nip.module(x))
        Yd = leaf(Y)
        m = timer('manipulations fwd', lambda: flow._manipulate(Yd))
        md = leaf(m)
        c = timer('pool fwd', lambda: flow._downsample(md))
        cd = leaf(c)
        C = timer('jpeg channel fwd', lambda: flow._compress(cd, *q)[0])
        Cd = leaf(C)
        p = timer('fan fwd', lambda: flow.fan.module(Cd))
        loss = timer('loss fwd', lambda: forensics.sparse_categorical_crossentropy(labels, p)
                     + lambda_nip * flow.nip.loss(y, Yd.permute(0, 2, 3, 1)))
        g_p, g_Y_loss = timer('loss bwd', lambda: grad(loss, [p, Yd]))
        g_C, *g_fan = timer('fan bwd', lambda: grad(p, [Cd] + fan_params, g_p))
        g_c, = timer('jpeg channel bwd', lambda: grad(C, [cd], g_C))
        g_m, = timer('pool bwd', lambda: grad(c, [md], g_c))
        g_Y, = timer('manipulations bwd', lambda: grad(m, [Yd], g_m))
        g_nip = timer(f'{nip} bwd', lambda: grad(Y, nip_params, g_Y + g_Y_loss))

        def adam():
            for param, g in zip(nip_params + fan_params, list(g_nip) + g_fan):
                param.grad = g
            flow.optimizer.step()
            flow.optimizer.zero_grad(set_to_none=True)
        timer('adam', adam)
    return timer.medians()


def train(args):
    """The --train mode: stage times, step wall and host queuing times
    (before any profiler session, and again after them: ``torch.profiler``
    leaves the host's launches slower in the process), and the device and
    host profiles."""
    lambda_nip, batch, raw_patch = TRAIN_LAMBDA_NIP, args.batch, RAW_PATCH
    if args.bf16:
        flow = bench_flow('cuda', args.seed)
    elif args.nip:
        flow = nip_flow(args.nip, 'cuda', seed=args.seed)
        lambda_nip, batch, raw_patch = NIP_FLOW_LAMBDA, NIP_FLOW_BATCH, NIP_RAW_PATCH
    else:
        flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, trainable={'nip'},
                                                  device='cuda')
        flow.nan_check = False
    (bx, by), = training_batches(args.seed, 1, batch, raw_patch)

    def step():
        flow.training_step(bx, by, lambda_nip)

    for _ in range(3):
        step()
    reps = args.requests
    wall_ms, queue_ms = median_ms(step, reps), median_ms(step, reps, sync=False)
    stages = train_stage_times(flow, bx.permute(0, 3, 1, 2).contiguous(), by, lambda_nip, reps)
    for name, ms in stages.items():
        print(f'[train stage] {name:26s} {ms:8.3f} ms stream', flush=True)
    p = device_profile(step, reps, n_top=20, match=('jpeg8x8',))
    print_profile('train step', p)
    host = host_ops(step, reps)
    wall_after, queue_after = median_ms(step, reps), median_ms(step, reps, sync=False)
    print(f'[train step] median wall {wall_ms:.3f} ms, host queuing {queue_ms:.3f} ms (no '
          f'synchronize); after the profiler sessions {wall_after:.3f} and {queue_after:.3f} '
          f'ms; {host["host_ops_per_call"]:.0f} host-side operator calls a step', flush=True)
    for row in host['top_host_ops']:
        print(f"[train host] {row['self_cpu_ms_per_call']:8.3f} ms x{row['calls_per_call']:6.1f} "
              f"{row['op']}", flush=True)
    flow.assert_finite()
    return {'device': torch.cuda.get_device_name(0), 'batch': batch, 'bf16': args.bf16,
            'nip': flow.nip.class_name,
            'step_wall_ms_median': wall_ms, 'step_host_queue_ms_median': queue_ms,
            'step_wall_ms_after_profiling': wall_after,
            'step_host_queue_ms_after_profiling': queue_after, **host,
            'stage_stream_ms': stages, 'stage_stream_ms_sum': sum(stages.values()), **p}


def host_ops(fn, reps, n_top=15):
    """The host side of ``fn`` from ``torch.profiler`` (CPU activity only):
    operator calls a call, and the ``n_top`` operators by self CPU time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {'host_ops_per_call': sum(e.count for e in events) / reps,
            'top_host_ops': [{'op': e.key[:60], 'calls_per_call': e.count / reps,
                              'self_cpu_ms_per_call': e.self_cpu_time_total / 1e3 / reps}
                             for e in events[:n_top]]}


def median_ms(fn, reps, sync=True):
    """Median wall ms of ``fn`` over ``reps`` calls after one warm-up; with
    ``sync`` each call ends in a synchronize, else it times what the host
    spends queuing the call (then waits for the device, untimed)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e3 * float(np.median(walls))


def trainer_costs(args):
    """The --trainer mode: what a step and a validation point of the trainer
    cost on the host and on the card at ``chip_smoke.py``'s trainer
    configuration (m_quality flow, NIP trainable, batch 10, raw 128 px, 40
    validation patches of 256 px)."""
    tmp = tempfile.mkdtemp(prefix='profile_trainer_')
    try:
        data_dir = fixtures.make_dataset(os.path.join(tmp, 'data'), n_images=TRAINER_IMAGES,
                                         height=TRAINER_SIZE[0], width=TRAINER_SIZE[1],
                                         seed=args.seed + 1000)
        n_images, v_images, val_patches = TRAINER_SPLIT
        data = Dataset(data_dir, n_images=n_images, v_images=v_images,
                       val_rgb_patch_size=2 * RAW_PATCH, val_n_patches=val_patches)
        flow = trainer_flow('cuda')
        flow.nan_check = False
        flow.nip.load_model(str(base.REPO_ROOT / 'data/models/nip/SyntheticCam/INet_gbrg_5x5'))
        reps = args.requests
        batch = data.next_training_batch(0, TRAINER_BATCH, 2 * RAW_PATCH, quantized=True)
        bx, by = to_device(batch, flow.device)
        step = lambda: flow.training_step(bx, by, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR)
        sampler = DeviceSampler(data, TRAINER_BATCH, 2 * RAW_PATCH, device=flow.device)
        prefetcher = EpochPrefetcher(data, TRAINER_BATCH, 2 * RAW_PATCH, flow.device)
        steps = n_images // TRAINER_BATCH

        def epoch_inline():
            for b in data.get_training_generator(TRAINER_BATCH, 2 * RAW_PATCH, quantized=True):
                flow.training_step(*to_device(b, flow.device), TRAIN_LAMBDA_NIP,
                                   learning_rate=TRAIN_LR)

        developed = {}

        def nip_on_card():
            x, _ = data.validation_tensors(flow.device)
            developed['y'] = flow.nip.process(x).clamp(0, 1).cpu().numpy()

        def nip_metrics():
            _, y = data.next_validation_batch(0, data.count_validation)
            for b in range(data.count_validation):
                metrics.ssim(y[b], developed['y'][b])
                metrics.psnr(y[b], developed['y'][b])

        def saves():
            validation.save_training_progress({}, flow, tmp, quiet=True)
            flow.fan.save_model(os.path.join(tmp, 'models', 'fan'), quiet=True)
            flow.nip.save_model(os.path.join(tmp, 'models', 'inet'), quiet=True)

        out = {
            'device': torch.cuda.get_device_name(0), 'batch': TRAINER_BATCH,
            'host_sample_batch_ms': median_ms(lambda: data.next_training_batch(
                0, TRAINER_BATCH, 2 * RAW_PATCH, quantized=True), reps),
            'copy_batch_ms': median_ms(lambda: to_device(batch, flow.device), reps),
            'step_host_queue_ms': median_ms(step, reps, sync=False),
            'step_wall_ms': median_ms(step, reps),
            'device_sample_ms': median_ms(lambda: sampler(0), reps),
            'scan_step_wall_ms': median_ms(lambda: flow.training_scan(
                sampler, 1, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR), reps),
            'epoch_prefetched_ms': median_ms(lambda: [step() for _ in prefetcher], 3),
            'epoch_inline_ms': median_ms(epoch_inline, 3),
            'epoch_device_resident_ms': median_ms(lambda: flow.training_scan(
                sampler, steps, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR), 3),
            'validate_fan_ms': median_ms(lambda: validation.validate_fan(flow, data), 3),
            'validate_nip_ms': median_ms(lambda: validation.validate_nip(flow.nip, data), 3),
            'nip_on_card_ms': median_ms(nip_on_card, 3),
            'nip_host_metrics_ms': median_ms(nip_metrics, 3),
            'save_log_and_models_ms': median_ms(saves, 3),
        }
        profile_step = device_profile(step, reps)
        out['step_device_ms'] = profile_step['device_ms_per_call']
        out['step_device_ops'] = profile_step['device_ops_per_call']
        flow.assert_finite()
        for name, value in out.items():
            print(f'[trainer cost] {name:24s} {value}', flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch', type=int, default=20)
    parser.add_argument('--requests', type=int, default=10)
    parser.add_argument('--train', action='store_true',
                        help='profile a training step instead of a request')
    parser.add_argument('--bf16', action='store_true',
                        help="with --train: bench.py's bfloat16 configuration")
    parser.add_argument('--nip', choices=['UNet', 'DNet'], default=None,
                        help="with --train: that NIP's λ-sweep run instead of m_quality's INet")
    parser.add_argument('--trainer', action='store_true',
                        help="split the trainer's step and validation point into host and "
                             'card costs')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_slice: needs a CUDA device')
    if args.train:
        print(json.dumps(train(args)))
        return
    if args.trainer:
        print(json.dumps(trainer_costs(args)))
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
