"""
Train camera ISPs (NIPs) with the PyTorch port: the counterpart of the
repository's ``train_nip.py``, with its flags, their names and defaults,
plus ``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.train_nip --nip UNet --cam D90 \\
        --data DIR --split 120:30:1 --patch 64 --batch 20 --epochs 10000

Model hyper-parameters come from ``--params`` (JSON) or, one scenario a row,
from the CSV of ``--hp`` (read with the ``csv`` module: an 'active' column
selects rows, a 'run_group' column sub-selects with ``--group``, and a cell
that starts with '@' is evaluated). A ClassicISP takes the CFA and the sRGB
matrix of ``--cam`` from ``--cameras-config`` where it lists that camera.

Data parallelism takes the JAX CLI's flags: ``--devices n`` starts n ranks
on this host, one device each (the first n cards, or n CPU processes over
gloo with ``--device cpu``), rank 0 the primary that writes the files;
``--coordinator host:port --nproc n --procid i`` makes this process rank i
of n. ``--fill`` summarizes the trained models under ``--out``
(``results_data.nip_stats``) instead of training: ``-`` prints the table,
a ``*.csv`` path writes it (pandas' bytes), anything else is refused.
"""
import argparse
import csv
import json
import os

import numpy as np

from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import pipelines
from neural_imaging_tpu_torch.parallel import launch, multihost
from neural_imaging_tpu_torch.parallel import train as ptrain
from neural_imaging_tpu_torch.training.pipeline import train_nip_model
from neural_imaging_tpu_torch.utils import results_data
from neural_imaging_tpu_torch.utils.utils import match_option, setup_logging

def parse_json_arg(text):
    """Parse a JSON CLI argument tolerating single quotes."""
    if text is None:
        return {}
    return json.loads(text.replace("'", '"'))


def parse_split(split):
    """'n:v:p' → (n_images, v_images, val_n_patches)."""
    parts = [int(x) for x in split.split(':')]
    while len(parts) < 3:
        parts.append(1)
    return tuple(parts[:3])


def _column(cells):
    """A CSV column's cells typed as pandas' reader types a column: all ints,
    else all numbers (floats), else all 'True'/'False', else strings; an
    empty cell of a numeric column is NaN."""
    filled = [c for c in cells if c != '']
    for cast in (int, float):
        try:
            values = [cast(c) for c in filled]
        except ValueError:
            continue
        if cast is int and len(filled) < len(cells):
            continue                     # pandas makes an int column with gaps float
        it = iter(values)
        return [next(it) if c != '' else float('nan') for c in cells]
    if filled and all(c in ('True', 'False') for c in filled) and len(filled) == len(cells):
        return [c == 'True' for c in cells]
    return [c if c != '' else float('nan') for c in cells]


def get_scenarios(csv_path, run_group=None):
    """Hyper-parameter scenarios from a CSV table, one dict a row: the
    columns map to model arguments; rows whose 'active' is 0 are dropped,
    ``run_group`` keeps the rows of that 'run_group', and an '@'-prefixed
    cell is evaluated."""
    with open(csv_path, newline='') as f:
        reader = csv.DictReader(f)
        names = reader.fieldnames or []
        rows = list(reader)
    columns = {name: _column([row[name] for row in rows]) for name in names}
    table = [{name: columns[name][i] for name in names} for i in range(len(rows))]
    if run_group is not None:
        if 'run_group' not in names:
            raise ValueError(f'--group given but {csv_path} has no run_group column')
        table = [row for row in table if row['run_group'] == run_group]
    if 'active' in names:
        table = [row for row in table if row['active'] != 0]
    scenarios = []
    for row in table:
        params = {}
        for key, value in row.items():
            if key in ('active', 'run_group'):
                continue
            if isinstance(value, str) and value.startswith('@'):
                value = eval(value[1:])  # noqa: S307 - the scenario table's explicit escape
            params[key] = value
        scenarios.append(params)
    return scenarios


def build_parser():
    parser = argparse.ArgumentParser(description='Train camera ISPs (NIP models, PyTorch port)')
    parser.add_argument('--nip', default='INet', help='NIP model class')
    parser.add_argument('--cam', default='D90', help='camera / dataset name')
    parser.add_argument('--data', default=None, help='explicit data directory')
    parser.add_argument('--split', default='120:30:1', help='n_images:v_images:v_patches')
    parser.add_argument('--epochs', type=int, default=10000)
    parser.add_argument('--patch', type=int, default=64, help='RAW patch size')
    parser.add_argument('--batch', type=int, default=20)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--out', default='./data/models/nip')
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--dry', action='store_true', help='print the setup and exit')
    parser.add_argument('--params', '--ha', dest='params', default=None,
                        help='JSON with model hyper-parameters')
    parser.add_argument('--hp', default=None, help='CSV with hyper-param scenarios')
    parser.add_argument('--group', type=int, default=None,
                        help='run_group to sub-select scenarios from the CSV')
    parser.add_argument('--val-schedule', type=int, default=100)
    parser.add_argument('--lr-schedule', default=None,
                        help="JSON {epoch: lr} decay schedule, e.g. "
                             "\"{'0': 1e-4, '4000': 5e-5}\" (overrides --lr)")
    parser.add_argument('--val-threshold', default=None,
                        help="early-stop threshold on relative validation-loss "
                             "change (default 1e-3; 'none' disables early stop)")
    parser.add_argument('--device-data', action='store_true',
                        help='copy the training set to the device once and sample patches '
                             'there')
    parser.add_argument('--cameras-config', default='config/cameras.json')
    parser.add_argument('-f', '--fill', default=None,
                        help="summarize trained models: '-' to print, or a CSV path")
    ptrain.add_cli_args(parser)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def fill(args):
    """The summary of the trained models under ``--out``: printed for '-',
    written for a '*.csv' path; returns it."""
    table = results_data.nip_stats(args.out)
    if args.fill == '-':
        print(table.to_string(index=False))
    elif args.fill.endswith('.csv'):
        table.to_csv(args.fill)
        print(f'Saved results to {args.fill}')
    else:
        raise ValueError(f'Invalid value for the results file: {args.fill}')
    return table


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()
    if args.fill is not None:
        return fill(args)
    if launch.launch_cli_ranks('neural_imaging_tpu_torch.cli.train_nip', argv, args, args.batch):
        return
    parallel = ptrain.from_cli_args(args, batch_size=args.batch)
    try:
        _train(args, parallel)
    finally:
        multihost.shutdown()


def _train(args, parallel):

    nip_name = match_option(args.nip, pipelines.supported_models)
    scenarios = (get_scenarios(args.hp, run_group=args.group) if args.hp
                 else [parse_json_arg(args.params)])
    n_images, v_images, val_n_patches = parse_split(args.split)
    lr_schedule = ({int(k): float(v) for k, v in parse_json_arg(args.lr_schedule).items()}
                   if args.lr_schedule else {0: args.lr})
    threshold = (1e-3 if args.val_threshold is None
                 else None if args.val_threshold == 'none' else float(args.val_threshold))

    data = None
    for params in scenarios:
        print(f'\n# Scenario: {nip_name} {params}')
        if args.dry:
            continue
        if data is None:
            data = Dataset(args.data or args.cam, n_images=n_images, v_images=v_images,
                           val_rgb_patch_size=2 * args.patch, val_n_patches=val_n_patches)
        model = getattr(pipelines, nip_name)(patch_size=args.patch, device=args.device,
                                             **params)
        if nip_name == 'ClassicISP' and os.path.isfile(args.cameras_config):
            with open(args.cameras_config) as f:
                cameras = json.load(f)
            if args.cam in cameras:
                model.set_cfa_pattern(cameras[args.cam]['cfa'])
                model.set_srgb_conversion(np.array(cameras[args.cam]['srgb']))
        train_nip_model(model, args.cam, n_epochs=args.epochs, lr_schedule=lr_schedule,
                        validation_schedule=args.val_schedule,
                        validation_loss_threshold=threshold, resume=args.resume,
                        patch_size=args.patch, batch_size=args.batch, data=data,
                        out_directory_root=args.out, device_data=args.device_data,
                        parallel=parallel)


if __name__ == '__main__':
    main()
