"""
Re-validate finished manipulation-classification runs on another dataset,
optionally under another channel, with the PyTorch port: the counterpart of
the repository's ``test_fan.py``, with its flags, their names and defaults,
plus ``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.test_fan --run-dir RUN --data DIR
    python -m neural_imaging_tpu_torch.cli.test_fan --dir ROOT --re REGEX --data DIR

A single run (``--run-dir``) or every ``**/training.json`` under ``--dir``
whose path matches ``--re``. Each run is rebuilt from its log with the
overrides given (``--jpeg``, ``--codec``, ``--dcn``, ``--ds``, ``--manip``
and the three dtypes; ``--codec libjpeg`` builds the 'libjpeg' channel,
which rounds 'soft' inside the flow, as the reference's does), validated on
the dataset's validation patches (an ONet run on its RGB images, any other
on its RAW ones; a dataset is loaded once per mode), and printed with its
validated against its logged accuracy and its confusion table.
"""
import argparse
import json
import os
import re
import sys
from pathlib import Path

import numpy as np

from neural_imaging_tpu_torch.cli.train_manipulation import parse_split
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.training import validation
from neural_imaging_tpu_torch.utils import results_data
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)


def restore_flow(training_json, args):
    """Rebuild the flow of a run from its ``training.json`` with the
    overrides of ``args`` (those of :func:`build_parser`); returns (flow,
    the last validation accuracy its log records, or nan)."""
    run_dir = os.path.dirname(training_json)
    with open(training_json) as f:
        log = json.load(f)

    distribution = dict(log['distribution'])
    if args.jpeg is not None:
        distribution.update(compression='jpeg',
                            compression_params={'quality': args.jpeg,
                                                'codec': args.codec or 'soft'})
    elif args.codec is not None:
        params = dict(distribution.get('compression_params') or {})
        params['codec'] = args.codec
        distribution.update(compression='jpeg', compression_params=params)
    if args.dcn is not None:
        distribution.update(compression='dcn', compression_params={'dirname': args.dcn})
    if args.ds is not None:
        distribution['downsampling'] = args.ds
    manipulations = args.manip.split(',') if args.manip is not None else None

    flow = ManipulationClassification.restore(
        run_dir, args.patch, channel_dtype=args.channel_dtype,
        channel_jpeg_dtype=args.channel_jpeg_dtype, manip_jpeg_dtype=args.manip_jpeg_dtype,
        manipulations=manipulations, distribution=distribution, device=args.device)
    history = (log['forensics'].get('performance', {})
               .get('accuracy', {}).get('validation', []))
    return flow, float(history[-1]) if history else np.nan


def build_parser():
    parser = argparse.ArgumentParser(description='Cross-dataset FAN validation (PyTorch port)')
    parser.add_argument('--run-dir', default=None,
                        help='single workflow run directory (contains training.json + models/)')
    parser.add_argument('--dir', default=None,
                        help='root directory to scan for **/training.json runs')
    parser.add_argument('--re', dest='regex', default=None,
                        help='regex filter on training.json paths found under --dir')
    parser.add_argument('--data', required=True, help='dataset directory to validate on')
    parser.add_argument('--split', default='0:-1:2', help='n:v:p — validation-only by default')
    parser.add_argument('--patch', type=int, default=64, help='RAW patch size')
    parser.add_argument('--jpeg', type=int, default=None, help='override channel JPEG quality')
    parser.add_argument('--codec', default=None, choices=['soft', 'sin', 'harmonic', 'libjpeg'],
                        help='override channel JPEG codec')
    parser.add_argument('--dcn', default=None,
                        help='override channel DCN model (a directory or preset)')
    parser.add_argument('--ds', default=None, choices=['pool', 'bilinear', 'none'],
                        help='override downsampling')
    parser.add_argument('--manip', default=None,
                        help='override manipulation list, e.g. sharpen,jpeg,gaussian')
    parser.add_argument('--channel-dtype', default=None, choices=['float32', 'bfloat16'],
                        help='override the recorded distribution-channel dtype')
    parser.add_argument('--channel-jpeg-dtype', default=None, choices=['float32', 'bfloat16'],
                        help='override the recorded channel-dJPEG dtype')
    parser.add_argument('--manip-jpeg-dtype', default=None, choices=['float32', 'bfloat16'],
                        help='override the recorded manipulation-dJPEG dtype')
    parser.add_argument('--randomize', action='store_true',
                        help='validate with randomized manipulation strengths (the '
                             'distribution `--augment` training optimizes) instead '
                             'of the fixed canonical strengths')
    parser.add_argument('--repeats', type=int, default=1,
                        help='validation passes to aggregate (independent strength '
                             'draws when --randomize)')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.run_dir is None) == (args.dir is None):
        parser.error('specify exactly one of --run-dir or --dir')

    if args.run_dir is not None:
        json_files = [os.path.join(args.run_dir, 'training.json')]
    else:
        json_files = sorted(str(f) for f in Path(args.dir).glob('**/training.json'))
        if not json_files:
            print(f'No training sessions under {args.dir}')
            return 0
        print(f'Found {len(json_files)} candidate training sessions ({args.dir})')

    n_images, v_images, val_n_patches = parse_split(args.split)
    # a scan may mix ONet runs (RGB, load 'y') with RAW-input runs (load
    # 'xy'): the mode is chosen per run and each dataset is loaded once
    datasets = {}
    for filename in json_files:
        if args.regex is not None and not re.findall(args.regex, filename):
            print(f'Skipping {filename}...')
            continue

        flow, expected = restore_flow(filename, args)
        print(flow.summary())

        load = 'y' if flow.nip.class_name == 'ONet' else 'xy'
        if load not in datasets:
            try:
                datasets[load] = Dataset(args.data, load=load, n_images=n_images,
                                         v_images=v_images, val_rgb_patch_size=2 * args.patch,
                                         val_n_patches=val_n_patches)
                print(f'Data ({load}): {datasets[load].summary()}')
            except (OSError, ValueError) as e:
                print(f"Skipping {filename}: cannot load the dataset in '{load}' mode ({e})")
                datasets[load] = None
        data = datasets[load]
        if data is None:
            print(f"Skipping {filename}: no dataset available in '{load}' mode")
            continue

        accuracy, conf = validation.validate_fan(flow, data, randomize=args.randomize,
                                                 repeats=args.repeats)
        mode = ' [randomized strengths]' if args.randomize else ''
        print(f'\nAccuracy validated/expected{mode}: {accuracy:.4f} / {expected:.4f}\n')
        print(results_data.confusion_to_text(100 * conf, flow._forensics_classes,
                                             title=filename))
    return 0


if __name__ == '__main__':
    sys.exit(main())
