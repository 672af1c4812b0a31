#!/usr/bin/env python3
"""
Where the PyTorch port's DCN paths spend their time on the GPU.

- Serving (one 512x768 RGB image per request through the 32c codec): the
  request's wall time, split into the encoder on the device
  (``dcn.compress``, input copy and K2 included), the host's part of
  ``codec.compress`` (latent copy to the host, nearest-codeword search
  ``codec._vq``, rANS coding), the decoder on the device and the host's part
  of ``codec.decompress``; the search and the coding alone, per feature map
  as the codec runs them; and from ``torch.profiler`` the device time per
  request, the device's busy share and the top kernels.
- Training (``training_step`` at batch 16 of 128-px patches, fixed codebook,
  then a trainable codebook): the step's wall time, and from
  ``torch.profiler`` the device time per step, the busy share, the top
  kernels and the codebook kernels' share.

    python3 profile_torch_dcn.py [--seed 0] [--requests 10] [--steps 10]

Needs a CUDA device. Prints one JSON line last.
"""
import argparse
import json
import time

import numpy as np
import torch

from chip_smoke import (DCN_BATCH, DCN_IMAGE, DCN_LR, DCN_PATCH, DCN_PRESET, device_profile,
                        print_profile, synthetic_rgb, trainable_dcn)
from neural_imaging_tpu_torch.compression import codec

# the names of K2-K4 and K4's row sum in the profiler's kernel list
CODEBOOK_KERNELS = ('codebook', 'sum_rows')


def wall_ms(fn, reps):
    """Median host-clock ms of ``fn`` over ``reps`` calls, each ending in a
    synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def serving(args):
    dcn = codec.restore(DCN_PRESET, device='cuda')
    image = synthetic_rgb(args.seed + 100, 1, *DCN_IMAGE)
    blob = codec.compress(image, dcn)
    codec.decompress(blob, dcn)
    latent_host = dcn.compress(image).cpu().numpy()
    code_book = dcn.get_codebook()
    maps = [latent_host[0, :, :, n] for n in range(latent_host.shape[-1])]
    indices = [codec._vq(m, code_book) for m in maps]

    def request():
        codec.decompress(codec.compress(image, dcn), dcn)
    stages = {
        'request': wall_ms(request, args.requests),
        'codec.compress': wall_ms(lambda: codec.compress(image, dcn), args.requests),
        'encoder (dcn.compress)': wall_ms(lambda: dcn.compress(image), args.requests),
        'nearest codeword (_vq)': wall_ms(lambda: [codec._vq(m, code_book) for m in maps],
                                          args.requests),
        'rANS coding': wall_ms(lambda: [codec._code_layer(i) for i in indices], args.requests),
        'codec.decompress': wall_ms(lambda: codec.decompress(blob, dcn), args.requests),
        'decoder (dcn.decompress + copy)': wall_ms(
            lambda: dcn.decompress(latent_host).cpu(), args.requests),
    }
    stages['host part of codec.compress'] = (stages['codec.compress']
                                             - stages['encoder (dcn.compress)'])
    stages['host part of codec.decompress'] = (stages['codec.decompress']
                                               - stages['decoder (dcn.decompress + copy)'])
    for name, ms in stages.items():
        print(f'[serve] {name:34s} {ms:9.3f} ms', flush=True)
    p = device_profile(request, args.requests, match=CODEBOOK_KERNELS)
    print_profile('serve', p)
    return {'image': list(DCN_IMAGE), 'bytes': len(blob), 'stage_wall_ms': stages, **p}


def training(args):
    batch = synthetic_rgb(args.seed + 200, DCN_BATCH, DCN_PATCH, DCN_PATCH)
    fixed = codec.restore(DCN_PRESET, patch_size=DCN_PATCH, device='cuda')
    trainable = trainable_dcn(DCN_PRESET, DCN_PATCH, 'cuda')
    out = {}
    for label, dcn in (('fixed', fixed), ('trainable', trainable)):
        def step():
            dcn.training_step(batch, DCN_LR)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        step_ms = wall_ms(step, args.steps)
        print(f'[train {label}] median step {step_ms:.3f} ms', flush=True)
        p = device_profile(step, args.steps, match=CODEBOOK_KERNELS)
        print_profile(f'train {label}', p)
        out[label] = {'step_wall_ms': step_ms, **p}
    return {'batch': DCN_BATCH, 'patch': DCN_PATCH, **out}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--requests', type=int, default=10)
    parser.add_argument('--steps', type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_dcn: needs a CUDA device')
    result = {'device': torch.cuda.get_device_name(0), 'serving': serving(args),
              'training': training(args)}
    print(json.dumps(result))


if __name__ == '__main__':
    main()
