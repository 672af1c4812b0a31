"""
Inspect trained DCN codecs with the PyTorch port: the counterpart of the
repository's ``test_dcn.py``, with its modes, flags and defaults, plus
``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.test_dcn MODE [--dcn 32c] [--data DIR]

- ``batch``: each image through the real bitstream (its SSIM and bpp) and
  the latent's entropy;
- ``jpeg-match-ssim`` / ``jpeg-match-bpp``: each image against libjpeg (the
  port's own codec) at the quality that matches the DCN's SSIM or bpp;
- ``rate-dist``: the per-image table (``--out`` writes it as CSV).

The codec compresses on the device through K2, once an image. The
reference's figures need matplotlib and are not written.
"""
import argparse

import numpy as np

from neural_imaging_tpu_torch.cli.test_jpeg import load_batch
from neural_imaging_tpu_torch.compression import codec as codec_mod, jpeg_helpers
from neural_imaging_tpu_torch.compression.ratedistortion import Table
from neural_imaging_tpu_torch.utils import metrics, stats

NO_FIGURE = 'figure: not written (the port draws no matplotlib figures)'


def mode_batch(dcn, batch, args):
    """Per-image SSIM / bpp and the latent's entropy; returns the statistics."""
    batch_z = dcn.compress(batch).cpu().numpy()
    _, st = codec_mod.compress_n_stats(batch, dcn)
    for i in range(len(batch)):
        ssim_i = np.atleast_1d(st['ssim'])[i]
        bpp_i = np.atleast_1d(st['bpp'])[i]
        print(f'image {i}: ssim {ssim_i:.3f} / {bpp_i:.2f} bpp')
    print(f'latent entropy H={stats.entropy(batch_z, dcn.get_codebook()):.2f}')
    print(NO_FIGURE)
    print({k: np.round(np.mean(v), 3) for k, v in st.items()})
    return st


def mode_jpeg_match(dcn, batch, args, match):
    """Each image against libjpeg at the quality matching the DCN's SSIM or
    bpp; returns [(i, dcn ssim, dcn bpp, qf, jpeg ssim, jpeg bpp)]."""
    rows = []
    for i, img in enumerate(batch):
        recon, nbytes = codec_mod.simulate_compression(img[None], dcn)
        dcn_ssim = metrics.ssim(img, recon[0])
        dcn_bpp = 8 * nbytes / (img.shape[0] * img.shape[1])
        target = dcn_ssim if match == 'ssim' else dcn_bpp
        qf = jpeg_helpers.match_quality(img, target=target, match=match)
        jimg, jbytes = jpeg_helpers.compress_batch(img, qf)
        j_ssim = metrics.ssim(img, jimg)
        j_bpp = 8 * jbytes / (img.shape[0] * img.shape[1])
        rows.append((i, dcn_ssim, dcn_bpp, qf, j_ssim, j_bpp))
        print(f'image {i}: DCN ssim {dcn_ssim:.3f} @ {dcn_bpp:.2f} bpp | '
              f'JPEG q{qf} ssim {j_ssim:.3f} @ {j_bpp:.2f} bpp')
    print(NO_FIGURE)
    return rows


def mode_rate_dist(dcn, batch, args):
    """The per-image table (image_id, codec, ssim, psnr, bpp); returns it."""
    rows = []
    for i, img in enumerate(batch):
        recon, nbytes = codec_mod.simulate_compression(img[None], dcn)
        rows.append({'image_id': i, 'codec': dcn.model_code,
                     'ssim': metrics.ssim(img, recon[0]),
                     'psnr': metrics.psnr(img, recon[0]),
                     'bpp': 8 * nbytes / (img.shape[0] * img.shape[1])})
    table = Table(rows, ['image_id', 'codec', 'ssim', 'psnr', 'bpp'])
    print(table.to_string())
    if args.out:
        table.to_csv(args.out)
        print(f'table -> {args.out}')
    return table


def build_parser():
    parser = argparse.ArgumentParser(description='Inspect trained DCN codecs (PyTorch port)')
    parser.add_argument('mode', choices=['batch', 'jpeg-match-ssim', 'jpeg-match-bpp',
                                         'rate-dist'])
    parser.add_argument('--dcn', default='32c', help='model dir or preset name')
    parser.add_argument('--data', default=None)
    parser.add_argument('--images', type=int, default=4)
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None):
    """Run one mode; returns what it printed (see the ``mode_*`` functions)."""
    args = build_parser().parse_args(argv)
    dcn = codec_mod.restore(args.dcn, device=args.device)
    batch = load_batch(args.data, args.images, 256, 256)
    if args.mode == 'batch':
        return mode_batch(dcn, batch, args)
    if args.mode == 'jpeg-match-ssim':
        return mode_jpeg_match(dcn, batch, args, 'ssim')
    if args.mode == 'jpeg-match-bpp':
        return mode_jpeg_match(dcn, batch, args, 'bpp')
    return mode_rate_dist(dcn, batch, args)


if __name__ == '__main__':
    main()
