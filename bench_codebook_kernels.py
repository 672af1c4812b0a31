#!/usr/bin/env python3
"""
Device time of the codebook kernels K2 (``codebook_fwd``), K3
(``codebook_bwd``) and K4 (``codebook_bwd_train``) of this tree against those
of another tree (``--baseline``: a directory that holds another
``neural_imaging_tpu_torch/``, for example a commit unpacked by
``git archive``), on one GPU, at the DCN paths' shapes: K2 at N = 196,608
(one 512x768 serving request) and N = 131,072 (one training step), K3 (on
the fixed integer codebook) and K4 (on a codebook moved off the integers) at
N = 131,072, L = 32.

Both trees' kernels are built from their own sources and called through
their own wrappers on the same inputs. Each is first held against the plain
version (0 hard-index flips, soft values within ``check_forward``, dz and
dcb within ``check_backward``). Then, in each of ``--rounds`` rounds, they
are timed in turns (baseline, this tree, this tree, baseline), each time the
median of ``--reps`` launches as ``chip_smoke.time_ms`` takes it (the
device's time alone, L2 flushed), and each launch apart by
``torch.profiler``. Bounds as ``chip_smoke.py`` computes them.

    python3 bench_codebook_kernels.py --baseline DIR [--rounds 3] [--reps 20] [--seed 0]

Needs a CUDA device. Prints one JSON line last.
"""
import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.ops.hopper import _build, codebook


def load_baseline(root):
    """The codebook wrapper module of the tree at ``root``, bound to a library
    built from that tree's ``csrc/codebook.cu``."""
    package = Path(root) / 'neural_imaging_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        'baseline_codebook', package / 'ops/hopper/codebook.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    path = _build.build([codebook.LIBRARY], csrc_dir=package / 'csrc')[codebook.LIBRARY]
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(path))   # what its _library() binds
    try:
        module._library()
    finally:
        _build.load = load
    return module


def cases(seed, device):
    """(label, kernel, N, inputs, work) at the DCN paths' shapes; ``work`` is
    one launch's (instructions, bytes)."""
    rng = np.random.default_rng(seed)
    cb = torch.from_numpy(quant.default_codebook(5)).to(device)
    out = []
    for n in (chip_smoke.DCN_IMAGE[0] * chip_smoke.DCN_IMAGE[1] // 2,
              chip_smoke.DCN_BATCH * chip_smoke.DCN_PATCH ** 2 // 2):
        z = torch.from_numpy((rng.standard_normal(n) * 4).astype(np.float32)).to(device)
        out.append((f'codebook_fwd N={n}', 'codebook_fwd', n, (z, cb),
                    codebook.codebook_fwd_work(z.shape, cb.shape)))
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    pc = torch.from_numpy(rng.standard_normal(cb.numel()).astype(np.float32)).to(device)
    out.append((f'codebook_bwd N={n}', 'codebook_bwd', n, (z, g, cb, pc),
                codebook.codebook_bwd_work(z.shape, g.shape, cb.shape)))
    out.append((f'codebook_bwd_train N={n}', 'codebook_bwd_train', n, (z, g, cb + 0.05, pc),
                codebook.codebook_bwd_train_work(z.shape, g.shape, cb.shape)))
    return out


def check(module, kernel, inputs):
    """Hold one tree's kernel against the plain version; returns the report."""
    if kernel == 'codebook_fwd':
        soft, hard = module.codebook_fwd_cuda(*inputs)
        report = codebook.check_forward(soft, hard, *codebook.codebook_fwd_plain(*inputs),
                                        inputs[1])
        if report['index_flips']:
            raise AssertionError(f'{module.__name__}: {report}')
        return report
    z, g, cb, pc = inputs
    if kernel == 'codebook_bwd':
        return codebook.check_backward(module.codebook_bwd_cuda(*inputs),
                                       codebook.codebook_bwd_plain(*inputs),
                                       codebook.backward_error_scale(*inputs)[0])
    dz, dcb = module.codebook_bwd_train_cuda(*inputs)
    dz_ref, dcb_ref = codebook.codebook_bwd_train_plain(*inputs)
    dz_scale, dcb_scale = codebook.backward_error_scale(z, g, cb, pc)
    reports = [codebook.check_backward(dz, dz_ref, dz_scale),
               codebook.check_backward(dcb, dcb_ref, dcb_scale, 'dcb')]
    if not torch.equal(module.codebook_bwd_train_cuda(*inputs)[1], dcb):
        raise AssertionError(f'{module.__name__}: dcb differs between two calls')
    return {key: max(r[key] for r in reports) for key in reports[0]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--baseline', required=True)
    parser.add_argument('--rounds', type=int, default=3)
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_codebook_kernels: needs a CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    device = torch.device('cuda')
    versions = {'baseline': load_baseline(args.baseline), 'this': codebook}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    results = []
    for label, kernel, n, inputs, work in cases(args.seed, device):
        bound_ms, bound_by = chip_smoke.bound(work)
        calls = {name: (lambda m=module: getattr(m, f'{kernel}_cuda')(*inputs))
                 for name, module in versions.items()}
        record = {'case': label, 'n': n, 'bound_ms': bound_ms, 'bound_by': bound_by}
        with torch.no_grad():
            for name, module in versions.items():
                record[f'{name}_agreement'] = check(module, kernel, inputs)
            times = {name: [] for name in versions}
            for _ in range(args.rounds):
                for name in ('baseline', 'this', 'this', 'baseline'):
                    times[name].append(chip_smoke.time_ms(calls[name], args.reps, flush))
            for name in versions:
                record[f'{name}_ms'] = times[name]
                record[f'{name}_median_ms'] = float(np.median(times[name]))
                record[f'{name}_share_of_bound'] = bound_ms / record[f'{name}_median_ms']
                record[f'{name}_launch_ms'] = chip_smoke.kernel_ms(calls[name], args.reps, flush)
        record['speedup'] = record['baseline_median_ms'] / record['this_median_ms']
        print(f'[{label}] baseline {record["baseline_median_ms"]:.4f} ms '
              f'({100 * record["baseline_share_of_bound"]:.1f}% of bound), this tree '
              f'{record["this_median_ms"]:.4f} ms ({100 * record["this_share_of_bound"]:.1f}%), '
              f'x{record["speedup"]:.2f}; bound {bound_ms:.4f} ms ({bound_by}); launches '
              f'baseline {chip_smoke.format_launches(record["baseline_launch_ms"])}, this '
              f'{chip_smoke.format_launches(record["this_launch_ms"])}', flush=True)
        results.append(record)
    print(json.dumps({'device': torch.cuda.get_device_name(0), 'nvidia_smi': smi,
                      'rounds': args.rounds, 'reps': args.reps, 'cases': results}))


if __name__ == '__main__':
    main()
