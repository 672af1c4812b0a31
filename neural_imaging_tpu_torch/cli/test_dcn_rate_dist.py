"""
Multi-codec rate-distortion comparison from cached CSV sweeps with the
PyTorch port: the counterpart of the repository's ``test_dcn_rate_dist.py``,
with its flags and defaults, plus ``--device`` (default ``cuda``; ``cpu``
must be asked for).

    python -m neural_imaging_tpu_torch.cli.test_dcn_rate_dist --data DIR [--metric ssim]

The legs of the reference, in its order (``compression/ratedistortion.py``,
each cached as CSV in ``--data``): JPEG, JPEG 2000, BPG, WebP, AVIF and,
when ``--dcn-models`` is a directory, the DCN codecs. A line first says which
codec libraries load (``rd.codec_libraries()``); a leg whose library or
binaries are absent prints the reason in place of its rows. In place of the
reference's figure each codec's fitted curve is printed (the per-image
fit-then-average when there are several images, else the pooled fit; with
``--bulk`` one pooled fit an image), and ``--out`` writes the curves as CSV
(codec, image_id, bpp and the metric; image_id is empty for a codec's curve
over all images).
"""
import argparse
import os

import numpy as np

from neural_imaging_tpu_torch.compression import ratedistortion as rd

# (leg, its sweep, the libraries it needs), in the reference's order
LEGS = (('JPEG', rd.get_jpeg_df, ()), ('JPEG 2000', rd.get_jpeg2k_df, ('libopenjp2',)),
        ('BPG', rd.get_bpg_df, ('bpgenc/bpgdec',)), ('WebP', rd.get_webp_df, ('libwebp',)),
        ('AVIF', rd.get_avif_df, ('libavif',)))
CURVE_POINTS = 5       # grid points printed a curve (--out keeps all 50)


def build_parser():
    parser = argparse.ArgumentParser(description='Rate-distortion comparison (PyTorch port)')
    parser.add_argument('--data', required=True, help='directory with benchmark images')
    parser.add_argument('--dcn-models', default='./data/models/dcn',
                        help='root with trained DCN models')
    parser.add_argument('--metric', default='ssim', choices=['ssim', 'psnr', 'msssim_db'])
    parser.add_argument('--force', action='store_true', help='recompute cached CSVs')
    parser.add_argument('--bulk', action='store_true', help='one fit an image')
    parser.add_argument('--out', default=None, help='CSV of the fitted curves')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def fit_curves(table, metric, bulk=False):
    """[(codec, image_id or None, grid, fitted)] of a sweep's codecs; a codec
    whose fit fails (a DCN has one sample an image) is printed as the mean of
    its samples and left out."""
    curves = []
    for codec in table.unique('codec'):
        sel = table.where(table['codec'] == codec)
        groups = sel.groupby('image_id') if bulk else [(None, sel)]
        for image_id, part in groups:
            try:
                if image_id is None and len(part.unique('image_id')) > 1:
                    grid, fitted = rd.fit_rd_curve_per_image(part, metric)
                else:
                    grid, fitted = rd.fit_rd_curve(part, metric)
            except (RuntimeError, ValueError, TypeError) as e:   # too few samples to fit
                print(f'{codec}: no {metric} fit ({e}); {len(part)} samples, mean '
                      f'{np.mean(part["bpp"]):.3f} bpp, {np.mean(part[metric]):.4f}')
                continue
            curves.append((codec, image_id, grid, fitted))
    return curves


def main(argv=None):
    """Run the legs and print the fitted curves; returns (tables, curves)."""
    args = build_parser().parse_args(argv)
    libraries = rd.codec_libraries()
    print('codec libraries: ' + '; '.join(f'{name} {text}' if ok else f'{name} absent ({text})'
                                         for name, (ok, text) in libraries.items()))
    tables = []
    for leg, sweep, needs in LEGS:
        absent = [f'{name}: {libraries[name][1]}' for name in needs if not libraries[name][0]]
        if absent:
            print(f'{leg}: no rows, ' + '; '.join(absent))
            continue
        tables.append(sweep(args.data, force_calc=args.force, device=args.device))
        print(f'{leg}: {len(tables[-1])} rows')
    if os.path.isdir(args.dcn_models):
        tables.append(rd.get_dcn_df(args.data, args.dcn_models, force_calc=args.force,
                                    device=args.device))
        print(f'DCN: {len(tables[-1])} rows')
    curves = []
    for table in tables:
        curves += fit_curves(table, args.metric, args.bulk)
    for codec, image_id, grid, fitted in curves:
        pick = np.linspace(0, len(grid) - 1, CURVE_POINTS).round().astype(int)
        points = ', '.join(f'{grid[i]:.3f} bpp: {fitted[i]:.4f}' for i in pick)
        label = codec if image_id is None else f'{codec} image {image_id}'
        print(f'{label} ({args.metric}): {points}')
    if args.out:
        rows = [{'codec': codec, 'image_id': float('nan') if image_id is None else image_id,
                 'bpp': b, args.metric: v}
                for codec, image_id, grid, fitted in curves for b, v in zip(grid, fitted)]
        rd.Table(rows, ['codec', 'image_id', 'bpp', args.metric]).to_csv(args.out)
        print(f'curves -> {args.out}')
    return tables, curves


if __name__ == '__main__':
    main()
