"""
Train learned codecs (DCNs) with the PyTorch port: the counterpart of the
repository's ``train_dcn.py``, with its flags, their names and defaults,
plus ``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.train_dcn --data DIR --split 200:50:1 \\
        --patch 64 --batch 50 --epochs 500 --param_list config/twitter.csv --group 1

Codec hyper-parameters come from ``--params`` (JSON) or, one scenario a
row, from the CSV of ``--param_list`` (``cli/train_nip.get_scenarios``:
rows whose 'active' is 0 are dropped, ``--group`` selects a 'run_group');
empty cells are left to the codec's defaults. Data parallelism takes the
JAX CLI's flags: ``--devices n`` starts n ranks on this host, one device
each (the first n cards, or n CPU processes over gloo with ``--device
cpu``), rank 0 the primary that writes the files; ``--coordinator
host:port --nproc n --procid i`` makes this process rank i of n. ``--fill``
adds a row a scenario (its parameters, the model code and the last
validation SSIM and loss and training entropy of its ``progress.json``) to a
results table: ``-`` prints it after the last scenario, a ``*.csv`` path
writes it (pandas' bytes); anything else is refused before training.
"""
import argparse
import os
import sys

from neural_imaging_tpu_torch.cli.train_nip import get_scenarios, parse_json_arg, parse_split
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import compression
from neural_imaging_tpu_torch.parallel import launch, multihost
from neural_imaging_tpu_torch.parallel import train as ptrain
from neural_imaging_tpu_torch.training.compression import train_dcn
from neural_imaging_tpu_torch.utils import jsonlog
from neural_imaging_tpu_torch.utils.table import Table
from neural_imaging_tpu_torch.utils.utils import setup_logging



def build_parser():
    parser = argparse.ArgumentParser(description='Train learned compression (DCN, PyTorch port)')
    parser.add_argument('--data', default='data/rgb/native12k/')
    parser.add_argument('--split', default='200:50:1')
    parser.add_argument('--epochs', type=int, default=500)
    parser.add_argument('--patch', type=int, default=64, help='RGB patch size')
    parser.add_argument('--batch', type=int, default=50)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--out', default='./data/models/dcn/playground')
    parser.add_argument('--dcn', default='TwitterDCN', help='DCN class name (models.compression)')
    parser.add_argument('--params', default=None, help='JSON with model hyper-parameters')
    parser.add_argument('--param_list', default=None, help='CSV scenario table')
    parser.add_argument('--group', type=int, default=None, help='run_group filter for the CSV')
    parser.add_argument('--val-schedule', type=int, default=50)
    parser.add_argument('--overwrite', action='store_true')
    parser.add_argument('--resume', action='store_true',
                        help='continue a previous run: npz weights, the Adam state '
                             '(adam.pt) and the epoch counter')
    parser.add_argument('--fill', default=None,
                        help="results table output: '-' prints the scenario table with "
                             "ssim/loss/entropy columns, '<path>.csv' saves it")
    parser.add_argument('--dry', action='store_true', help='print the scenarios and exit')
    parser.add_argument('--device-data', action='store_true',
                        help='copy the training set to the device once and sample and '
                             'augment patches there')
    ptrain.add_cli_args(parser)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None, rng=None):
    """The CLI on ``argv``. ``rng``: for callers in the same process, the
    numpy generator of the host-fed augmentations (``train_dcn``'s; without
    one each run draws from fresh entropy, as the command line does)."""
    args = build_parser().parse_args(argv)
    if args.fill is not None and args.fill != '-' and not args.fill.endswith('.csv'):
        raise SystemExit(f"--fill must be '-' or a .csv path, got {args.fill}")
    setup_logging()
    if launch.launch_cli_ranks('neural_imaging_tpu_torch.cli.train_dcn', argv, args, args.batch):
        return
    parallel = ptrain.from_cli_args(args, batch_size=args.batch)
    try:
        _train(args, parallel, rng)
    finally:
        multihost.shutdown()


def _train(args, parallel, rng=None):

    dcn_cls = getattr(compression, args.dcn, None)
    if not (isinstance(dcn_cls, type) and issubclass(dcn_cls, compression.DCN)):
        print(f'Unknown DCN class: {args.dcn}')
        sys.exit(1)

    scenarios = (get_scenarios(args.param_list, run_group=args.group) if args.param_list
                 else [parse_json_arg(args.params)])
    n_images, v_images, val_n_patches = parse_split(args.split)
    data = None
    results_rows = []
    for params in scenarios:
        params = {k: v for k, v in params.items() if v == v}  # drop NaN cells
        print(f'\n# Scenario: {args.dcn} {params}')
        if args.dry:
            continue
        if data is None:
            data = Dataset(args.data, load='y', n_images=n_images, v_images=v_images,
                           val_rgb_patch_size=args.patch, val_n_patches=val_n_patches)
        dcn = dcn_cls(patch_size=args.patch, device=args.device, **params)
        train_dcn(dcn, {'n_epochs': args.epochs, 'batch_size': args.batch,
                        'patch_size': args.patch, 'learning_rate': args.lr,
                        'validation_schedule': args.val_schedule},
                  data, directory=args.out, overwrite=args.overwrite,
                  device_data=args.device_data, resume=args.resume, parallel=parallel, rng=rng)
        if args.fill is not None:
            results_rows.append(result_row(args.out, params, dcn))

    if args.fill is not None and results_rows and multihost.is_primary():
        table = Table(results_rows)
        if args.fill == '-':
            print('\n# Training Results')
            print(table.to_string(index=True))
        else:
            print(f'Saving the results table to {args.fill}')
            table.to_csv(args.fill)


def result_row(directory, params, dcn):
    """A scenario's row of the results table: its parameters, the model code
    and, where the run wrote its ``progress.json``, the last validation SSIM
    and loss and the last training entropy."""
    row = {**params, 'model_code': dcn.model_code}
    progress = os.path.join(directory, dcn.model_code, dcn.scoped_name, 'progress.json')
    if os.path.isfile(progress):
        perf = jsonlog.load_json(progress)['codec']['performance']
        row['ssim'] = (perf['ssim']['validation'] or [float('nan')])[-1]
        row['loss'] = (perf['loss']['validation'] or [float('nan')])[-1]
        row['entropy'] = (perf['entropy']['training'] or [float('nan')])[-1]
    return row


if __name__ == '__main__':
    main()
