"""
Train learned codecs (DCNs) with the PyTorch port: the counterpart of the
repository's ``train_dcn.py``, with its flags, their names and defaults,
plus ``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.train_dcn --data DIR --split 200:50:1 \\
        --patch 64 --batch 50 --epochs 500 --param_list config/twitter.csv --group 1

Codec hyper-parameters come from ``--params`` (JSON) or, one scenario a
row, from the CSV of ``--param_list`` (``cli/train_nip.get_scenarios``:
rows whose 'active' is 0 are dropped, ``--group`` selects a 'run_group');
empty cells are left to the codec's defaults. ``--fill`` (the results
table, which needs pandas) and the parallel flags raise
``NotImplementedError`` naming ROADMAP.md §1 item 5.
"""
import argparse
import sys

from neural_imaging_tpu_torch.cli.train_nip import get_scenarios, parse_json_arg, parse_split
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import compression
from neural_imaging_tpu_torch.training.compression import train_dcn
from neural_imaging_tpu_torch.utils.utils import setup_logging

PARALLEL_FLAGS = ('devices', 'coordinator', 'nproc', 'procid')


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
    parser.add_argument('--fill', default=None, help='results table (not ported)')
    parser.add_argument('--dry', action='store_true', help='print the scenarios and exit')
    parser.add_argument('--device-data', action='store_true',
                        help='copy the training set to the device once and sample and '
                             'augment patches there')
    parser.add_argument('--devices', default=None, help='data-parallel devices (not ported)')
    parser.add_argument('--coordinator', default=None, help='multi-host (not ported)')
    parser.add_argument('--nproc', type=int, default=None, help='multi-host (not ported)')
    parser.add_argument('--procid', type=int, default=None, help='multi-host (not ported)')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def refuse_unported(args):
    """Raise NotImplementedError for an option the port does not have yet."""
    if args.fill is not None:
        raise NotImplementedError('--fill (the results table, which needs pandas) is not '
                                  'ported (ROADMAP.md §1 item 5)')
    if any(getattr(args, flag) is not None for flag in PARALLEL_FLAGS):
        raise NotImplementedError('the parallel trainer (--devices, --coordinator, --nproc, '
                                  '--procid) is not ported (ROADMAP.md §1 item 5)')


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    setup_logging()

    dcn_cls = getattr(compression, args.dcn, None)
    if not (isinstance(dcn_cls, type) and issubclass(dcn_cls, compression.DCN)):
        print(f'Unknown DCN class: {args.dcn}')
        sys.exit(1)

    scenarios = (get_scenarios(args.param_list, run_group=args.group) if args.param_list
                 else [parse_json_arg(args.params)])
    n_images, v_images, val_n_patches = parse_split(args.split)
    data = None
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
                  device_data=args.device_data, resume=args.resume)


if __name__ == '__main__':
    main()
