"""
Prepare RAW → RGB training pairs with the PyTorch port: the counterpart of
the repository's ``train_prepare_training_set.py``, with its flags, plus
``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.train_prepare_training_set --dir RAWS --out DATA

Every camera file of ``--dir`` (``.dng``, ``.cr2``, ``.nef``, ``.arw``, or a
synthetic ``.nraw.npz`` container) is read on the host (``raw.unpack``) into
a uint16 RGGB ``<stem>.npy`` stack and developed on the device into a
``<stem>.png`` target (``--dev auto`` and ``manual`` both develop with the
scratch pipeline here: bilinear, no brightness correction, as the reference
without rawpy). Portrait captures are skipped. ``--synthesize N`` writes N
procedural pairs instead.
"""
import argparse
import os
import time

import numpy as np

from neural_imaging_tpu_torch.data import png, raw
from neural_imaging_tpu_torch.utils.device import resolve_device
from neural_imaging_tpu_torch.utils.utils import logger, setup_logging

RAW_EXTENSIONS = ('.nef', '.dng', '.cr2', '.arw', '.raf', '.nraw.npz')


def raw_files(directory):
    """The RAW files of a directory, sorted, with their stems."""
    files = sorted(f for f in os.listdir(directory) if f.lower().endswith(RAW_EXTENSIONS))
    stems = []
    for filename in files:
        stem = filename
        for ext in RAW_EXTENSIONS:
            if stem.lower().endswith(ext):
                stem = stem[:-len(ext)]
                break
        stems.append(stem)
    return list(zip(files, stems))


def build_parser():
    parser = argparse.ArgumentParser(description='Prepare RAW→RGB training pairs (PyTorch port)')
    parser.add_argument('--dir', dest='data_dir', default=None,
                        help='directory with RAW files')
    parser.add_argument('--out', default=None, help='output directory (default: in place)')
    parser.add_argument('--dev', default='auto', choices=['auto', 'manual'],
                        help='development pipeline (both the scratch pipeline here)')
    parser.add_argument('--synthesize', type=int, default=0,
                        help='generate N synthetic RAW/RGB pairs instead of reading files')
    parser.add_argument('--height', type=int, default=512)
    parser.add_argument('--width', type=int, default=768)
    parser.add_argument('--seed', type=int, default=2023)
    parser.add_argument('--cfa', default='GBRG')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging()
    out_dir = args.out or args.data_dir
    if out_dir is None:
        parser.error('Either --dir or --out (with --synthesize) is required')

    if args.synthesize > 0:
        from neural_imaging_tpu_torch.data import fixtures
        os.makedirs(out_dir, exist_ok=True)
        fixtures.make_dataset(out_dir, n_images=args.synthesize, height=args.height,
                              width=args.width, seed=args.seed, cfa_pattern=args.cfa)
        logger.info('Synthesized %d RAW/RGB pairs in %s', args.synthesize, out_dir)
        return []

    device = resolve_device(args.device)
    os.makedirs(out_dir, exist_ok=True)
    files = raw_files(args.data_dir)
    if not files:
        logger.warning('No RAW files found in %s', args.data_dir)
        return []

    written = []
    for filename, stem in files:
        t0 = time.perf_counter()
        path = os.path.join(args.data_dir, filename)
        stack, *_ = raw.unpack(path)
        # keep only landscape-like orientation consistent with the reference filter
        if stack.shape[0] > stack.shape[1]:
            logger.info('skipping portrait-oriented %s', filename)
            continue

        np.save(os.path.join(out_dir, stem + '.npy'),
                np.clip(stack * (2 ** 16 - 1), 0, 2 ** 16 - 1).round().astype(np.uint16))
        if args.dev == 'auto':
            rgb = raw.process_auto(path, device=device)
        else:
            rgb = raw.to_uint8(raw.process(path, demosaicing='bilinear', brightness=None,
                                           device=device))
        png.write_png(os.path.join(out_dir, stem + '.png'), rgb)
        written.append(stem)
        logger.info('%s -> %s.npy + %s.png in %.2f s', filename, stem, stem,
                    time.perf_counter() - t0)
    return written


if __name__ == '__main__':
    main()
