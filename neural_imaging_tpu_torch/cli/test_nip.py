"""
Develop validation patches (or one RAW file) with a trained ISP and report
PSNR and SSIM: the counterpart of the repository's ``test_nip.py``, with its
flags, plus ``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.test_nip --nip UNet --cam QualityRef \\
        --data DIR [--model-dir DIR] [--patch 64] [--images 4]
    python -m neural_imaging_tpu_torch.cli.test_nip --nip INet --cam D90 --raw FILE.dng

The model is restored from ``--model-dir``, else from
``data/models/nip/<cam>/<model code>/<scoped name>`` when that exists (else
the initialized model is used, and said so). Each validation patch prints
``patch i: <PSNR> dB / SSIM <SSIM>``; the reference's figure needs
matplotlib and is not drawn. ``--raw`` develops one camera file
(``data/raw.py::unpack``) and writes the PNG.
"""
import argparse
import os

import numpy as np

from neural_imaging_tpu_torch.data import png, raw as raw_mod
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import base, pipelines
from neural_imaging_tpu_torch.utils import metrics

NO_FIGURE = 'figure: not written (the port draws no matplotlib figures)'


def load_nip(spec, cam, device, model_dir=None):
    """A NIP from a checkpoint directory (``model_dir``, or ``spec`` when it is
    a directory), else class ``spec`` with the camera's snapshot under
    ``data/models/nip`` where there is one; returns (model, loaded)."""
    directory = model_dir or (spec if os.path.isdir(spec) else None)
    if directory:
        return base.restore(directory, pipelines, patch_size=None, device=device), True
    model = getattr(pipelines, spec)(patch_size=None, device=device)
    candidate = os.path.join('data/models/nip', cam, model.model_code, model.scoped_name)
    if os.path.isdir(candidate):
        model.load_model(candidate)
        return model, True
    return model, False


def build_parser():
    parser = argparse.ArgumentParser(description='Test a trained NIP (PyTorch port)')
    parser.add_argument('--nip', default='INet')
    parser.add_argument('--cam', default='D90')
    parser.add_argument('--data', default=None)
    parser.add_argument('--model-dir', default=None,
                        help='trained model dir (default: data/models/nip/<cam>/<code>)')
    parser.add_argument('--raw', default=None, help='develop a single RAW file instead')
    parser.add_argument('--patch', type=int, default=64)
    parser.add_argument('--images', type=int, default=4)
    parser.add_argument('--out', default=None, help='output path (the PNG of --raw)')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None):
    """Returns [(psnr, ssim)] of the validation patches, or the developed
    RAW file's (h, w, 3) array with ``--raw``."""
    args = build_parser().parse_args(argv)
    model, loaded = load_nip(args.nip, args.cam, args.device, args.model_dir)
    if not loaded:
        candidate = os.path.join('data/models/nip', args.cam, model.model_code,
                                 model.scoped_name)
        print(f'(no checkpoint at {candidate}; using the initialized model)')

    if args.raw:
        stack, _, _, _ = raw_mod.unpack(args.raw)
        developed = model.process(stack[None].astype(np.float32))[0].cpu().numpy()
        out = args.out or os.path.splitext(args.raw)[0] + f'_{model.class_name}.png'
        png.write_png(out, (np.clip(developed, 0, 1) * 255).astype(np.uint8))
        print(f'developed -> {out}')
        return developed

    data = Dataset(args.data or args.cam, n_images=0, v_images=-1,
                   val_rgb_patch_size=2 * args.patch, val_n_patches=1)
    vx, vy = data.next_validation_batch(0, min(args.images, data.count_validation))
    developed = model.process(vx).clip(0, 1).cpu().numpy()
    scores = []
    for i in range(len(vx)):
        scores.append((metrics.psnr(vy[i], developed[i]), metrics.ssim(vy[i], developed[i])))
        print(f'patch {i}: {scores[-1][0]:.2f} dB / SSIM {scores[-1][1]:.3f}')
    print(NO_FIGURE)
    return scores


if __name__ == '__main__':
    main()
