"""
The differentiable JPEG against libjpeg's codec over a quality sweep, with
the PyTorch port: the counterpart of the repository's ``test_jpeg.py``, with
its flags and defaults, plus ``--device`` (default ``cuda``; ``cpu`` must be
asked for).

    python -m neural_imaging_tpu_torch.cli.test_jpeg [--dir DIR] [--images 4]

Each quality's dJPEG (float32 'soft' rounding on the card is the K1 kernel,
one launch a quality) and libjpeg's round trip (the port's own codec, on the
host) of the same batch, and their mean PSNR, one line a quality. The
reference's figure needs matplotlib and is not written.
"""
import argparse

import numpy as np
import torch

from neural_imaging_tpu_torch.compression import jpeg_helpers
from neural_imaging_tpu_torch.data import fixtures, loading
from neural_imaging_tpu_torch.models.jpeg import JPEG
from neural_imaging_tpu_torch.utils import metrics


def build_parser():
    parser = argparse.ArgumentParser(description='dJPEG vs libJPEG comparison (PyTorch port)')
    parser.add_argument('--dir', dest='data_dir', default=None,
                        help='directory with test images (default: procedural batch)')
    parser.add_argument('--images', type=int, default=4)
    parser.add_argument('--rounding', default='soft', choices=['soft', 'sin', 'harmonic'])
    parser.add_argument('--out', default=None, help='output figure path (not written)')
    parser.add_argument('--qmin', type=int, default=10)
    parser.add_argument('--qmax', type=int, default=95)
    parser.add_argument('--step', type=int, default=5)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def load_batch(data_dir, n_images, height=256, width=384):
    """The first images of a directory cropped to multiples of 8, else the
    procedural Kodak stand-in: float32 NHWC in [0, 1]."""
    if data_dir is None:
        return fixtures.kodak_like_batch(n=n_images, height=height, width=width)
    files, _ = loading.discover_images(data_dir, n_images=-1, v_images=0)
    batch = loading.load_images(files[:n_images], data_dir, load='y')['y']
    batch = batch.astype(np.float32) / 255.0
    return batch[:, :(batch.shape[1] // 8) * 8, :(batch.shape[2] // 8) * 8]


def main(argv=None):
    """Print the sweep; returns [(quality, dJPEG PSNR, libjpeg PSNR)]."""
    args = build_parser().parse_args(argv)
    batch = load_batch(args.data_dir, args.images)
    codec = JPEG(50, args.rounding, device=args.device)
    rows = []
    for qf in range(args.qmin, args.qmax + 1, args.step):
        soft = codec.process(torch.from_numpy(batch), qf).cpu().numpy()
        hard, _ = jpeg_helpers.compress_batch(batch, qf)
        psnr_soft = float(np.mean(metrics.psnr(batch, soft)))
        psnr_hard = float(np.mean(metrics.psnr(batch, hard)))
        rows.append((qf, psnr_soft, psnr_hard))
        print(f'QF {qf:3d}: dJPEG {psnr_soft:6.2f} dB | libJPEG {psnr_hard:6.2f} dB | '
              f'Δ {psnr_soft - psnr_hard:+.2f}')
    print('figure: not written (the port draws no matplotlib figures)')
    return rows


if __name__ == '__main__':
    main()
