#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``neural_imaging_tpu_torch``) on one
NVIDIA GPU:

1. environment: the card, its power limit, TF32 off;
2. build every hand-written CUDA kernel from ``neural_imaging_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and time both (CUDA events, L2 flushed);
4. drive the main path: restore the shipped ``m_quality`` run (INet → 4
   manipulations → pool → JPEG QF 50 → FAN, full width) and answer requests of
   raw 128-px patches with ``run_workflow_to_decisions``, counting kernel
   launches; check the probabilities, and against the same forward on the CPU;
5. print one JSON line of the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed 0] [--requests 5] [--batch 20]

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before doing anything.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from neural_imaging_tpu_torch.models.jpeg import qtables
from neural_imaging_tpu_torch.ops.hopper import _build, jpeg8x8
from neural_imaging_tpu_torch.utils.device import resolve_device
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification, compare_probabilities)

RUN_DIR = 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000'
RAW_PATCH = 128

# H100 SXM data sheet (dense, at the 700 W limit): the least time for a
# kernel's work is the larger of bytes / memory rate and FLOPs / peak rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
# K1 per pixel: 4 passes of 8-term dot products (8 FMA = 16 FLOP each) plus
# divide, round and multiply
K1_FLOP_PER_PIXEL = 4 * 16 + 3


def synthetic_raw(seed, n, patch):
    """(n, patch, patch, 4) RGGB stacks in [0, 1]: a smooth random field
    (bilinear over 16-px cells), light noise, linearized with gamma 2.2 —
    camera-like enough that the FAN's probabilities are not saturated."""
    rng = np.random.default_rng(seed)
    cells = patch // 16 + 1
    coarse = torch.from_numpy(rng.random((n, 4, cells, cells)).astype(np.float32))
    smooth = torch.nn.functional.interpolate(coarse, size=(patch, patch), mode='bilinear',
                                             align_corners=True)
    noise = torch.from_numpy(rng.standard_normal((n, 4, patch, patch)).astype(np.float32))
    x = (smooth + 0.01 * noise).clamp(0, 1) ** 2.2
    return x.permute(0, 2, 3, 1).contiguous().numpy()


def time_ms(fn, reps, flush):
    """Median device time of ``fn`` in ms over ``reps`` launches, each timed
    alone by CUDA events with the L2 cache flushed before it."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_k1(name, planes, q, reps, flush):
    """K1 against its plain version on the card at one shape; returns its record."""
    y_k, c_k = jpeg8x8.jpeg_core_cuda(planes, q)
    with torch.no_grad():
        y_p, c_p = jpeg8x8.jpeg_core_plain(planes, q)
    torch.cuda.synchronize()
    report = jpeg8x8.check_cores(y_k, c_k, y_p, c_p, q)
    with torch.no_grad():
        ms = time_ms(lambda: jpeg8x8.jpeg_core_cuda(planes, q), reps, flush)
        plain_ms = time_ms(lambda: jpeg8x8.jpeg_core_plain(planes, q), reps, flush)
    p, h, w = planes.shape
    pixels = p * h * w
    bytes_moved = 4 * (3 * pixels + q.numel() + 64)      # planes in, y and c out, tables
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = K1_FLOP_PER_PIXEL * pixels / F32_FLOP_PER_S * 1e3
    record = {'shape': name, 'P': p, 'H': h, 'W': w, 'ms': ms, 'plain_ms': plain_ms,
              'bound_ms': max(bound_bytes_ms, bound_ops_ms),
              'bound_by': 'bytes' if bound_bytes_ms >= bound_ops_ms else 'operations',
              **report}
    print(f'[k1] {name}: P={p} {h}x{w} flipped={report["flipped"]}/{report["coefficients"]} '
          f'max|dy| clean blocks={report["max_abs_err"]:.3g} all={report["max_abs_err_all"]:.3g} '
          f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {record["bound_ms"]:.4f} ms '
          f'({record["bound_by"]})', flush=True)
    return record


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--requests', type=int, default=5)
    parser.add_argument('--batch', type=int, default=20, help='raw patches per request')
    parser.add_argument('--reps', type=int, default=20, help='timed launches per kernel')
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1

    # 1. environment
    device = resolve_device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f'[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind} '
          f'x{torch.cuda.device_count()}; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} '
          f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}', flush=True)
    print(smi, flush=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('TF32 must be off on the float32 path')

    # 2. build
    t0 = time.perf_counter()
    libraries = _build.build([jpeg8x8.LIBRARY])
    print(f'[build] {len(libraries)} kernel library(ies) in {time.perf_counter() - t0:.1f} s',
          flush=True)
    for path in libraries.values():
        log = path.with_suffix('.log')
        if log.exists():
            print('[build] ' + log.read_text().strip().replace('\n', '\n[build] '), flush=True)

    # 3. kernels against their plain versions at the main path's shapes
    flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, device=device)
    n_rows = args.batch * flow.n_classes
    side = 2 * RAW_PATCH
    gen = torch.Generator().manual_seed(args.seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)   # > the 50 MB L2
    k1 = []
    for name, p, h, quality in (('manipulation jpeg:80', 3 * args.batch, side, 80),
                                ('channel QF50', 3 * n_rows, side // flow.downsampling_factor,
                                 flow.codec.quality)):
        planes = (torch.rand((p, h, h), generator=gen) * 255 - 127).to(device)
        q_luma, q_chroma = qtables(int(quality), device)
        q = torch.stack([q_luma, q_chroma, q_chroma]).repeat(p // 3, 1, 1).contiguous()
        k1.append(check_k1(name, planes, q, args.reps, flush))

    # 4. the main path
    batches = [synthetic_raw(args.seed + i, args.batch, RAW_PATCH) for i in range(args.requests)]
    flow.run_workflow_to_decisions(batches[0])          # warm-up (cuDNN autotuning, caches)
    torch.cuda.synchronize()
    jpeg8x8.jpeg_core_cuda.launches = 0
    latencies, decisions = [], []
    for i, batch in enumerate(batches):
        before = jpeg8x8.jpeg_core_cuda.launches
        t0 = time.perf_counter()
        decisions.append(flow.run_workflow_to_decisions(batch))
        latencies.append(time.perf_counter() - t0)
        launched = jpeg8x8.jpeg_core_cuda.launches - before
        print(f'[slice] request {i}: {args.batch} raw {RAW_PATCH}px patches → '
              f'{len(decisions[-1])} decisions in {1e3 * latencies[-1]:.2f} ms, '
              f'K1 launches {launched}', flush=True)
        if launched != 2:
            raise AssertionError(f'request {i} launched K1 {launched} times, expected 2')
    launches = {'jpeg8x8': jpeg8x8.jpeg_core_cuda.launches}
    if launches['jpeg8x8'] == 0:
        raise AssertionError('the main path never launched K1')
    median = float(np.median(latencies))
    print(f'[slice] median request {1e3 * median:.2f} ms: {args.batch / median:.1f} raw patches/s, '
          f'{n_rows / median:.1f} classified images/s', flush=True)

    probs = flow.run_workflow(batches[0])[-1]
    torch.cuda.synchronize()
    if tuple(probs.shape) != (n_rows, flow.n_classes) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f'bad probabilities: shape {tuple(probs.shape)}')
    row_sums = probs.sum(dim=1)
    if not bool(torch.allclose(row_sums, torch.ones_like(row_sums), atol=1e-5)):
        raise AssertionError(f'probability rows do not sum to 1: {row_sums}')
    if not np.array_equal(probs.argmax(dim=1).cpu().numpy(), decisions[0]):
        raise AssertionError('run_workflow_to_decisions disagrees with run_workflow')
    cpu_flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, device='cpu')
    report = compare_probabilities(probs.cpu(), cpu_flow.run_workflow(batches[0])[-1])
    print(f'[slice] request 0 vs the CPU: max |dp| {report["max_abs_diff"]:.3g}, '
          f'{report["decided_rows"]}/{report["rows"]} decided rows agree', flush=True)

    # 5. results: K1's numbers are its two launches of one request, summed
    print('[slice] ' + json.dumps({
        'requests': args.requests, 'batch': args.batch,
        'latency_ms': [1e3 * t for t in latencies], 'raw_patches_per_s': args.batch / median,
        'images_per_s': n_rows / median, 'cpu_max_abs_prob_diff': report['max_abs_diff'],
        'k1_shapes': k1}), flush=True)
    kernels = [{'name': 'jpeg8x8', 'route': 'cuda',
                'source': 'neural_imaging_tpu_torch/csrc/jpeg8x8.cu',
                'replaces': 'neural_imaging_tpu/ops/pallas/jpeg8x8.py:34',
                'launches': launches['jpeg8x8'],
                'max_abs_err': max(r['max_abs_err'] for r in k1),
                'ms': sum(r['ms'] for r in k1),
                'plain_ms': sum(r['plain_ms'] for r in k1),
                'bound_ms': sum(r['bound_ms'] for r in k1),
                'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in k1)
                             else 'operations'),
                'library_ms': None}]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
