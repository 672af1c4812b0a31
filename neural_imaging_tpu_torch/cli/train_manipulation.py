"""
Joint optimization of the acquisition → distribution → forensics workflow
with the PyTorch port: the counterpart of the repository's
``train_manipulation.py``, with its flags, their names and defaults, plus
``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.train_manipulation --nip INet \\
        --cam SyntheticCam --data DIR --split 40:20:2 --patch 128 --epochs 1001

It sweeps ``--cam``, the repetitions ``--start``..``--end`` and ``--ln`` /
``--lc`` (for a trainable NIP / codec) as the reference does, reusing one
flow through ``reinitialize()``. Data parallelism takes the JAX CLI's
flags: ``--devices n`` starts n ranks on this host, one device each (the
first n cards, or n CPU processes over gloo with ``--device cpu``), rank 0
the primary that writes the files; ``--coordinator host:port --nproc n
--procid i`` makes this process rank i of n. ``--jpeg_mode libjpeg`` makes the channel libjpeg's codec (the
port's own, on the host), which the flow replaces by 'soft' rounding, as
the reference's does. The NIP (INet, UNet, DNet or ClassicISP) starts from
its snapshot ``<--nip-dir>/<camera>/<model code>``
unless ``--scratch``; ONet takes RGB data (the dataset is loaded with
``load='y'``). ``--dcn <directory or preset>`` makes the channel a learned
codec, which ``--train dcn`` fine-tunes, weighted by ``--lc``. The
bfloat16 configuration the JAX package is tuned on: ``--channel-dtype
bfloat16 --channel-jpeg-dtype bfloat16 --manip-jpeg-dtype bfloat16 --fan
'{"dtype": "bfloat16"}'``.
"""
import argparse
import itertools
import json

from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.parallel import launch, multihost
from neural_imaging_tpu_torch.parallel import train as ptrain
from neural_imaging_tpu_torch.training.manipulation import train_manipulation_nip
from neural_imaging_tpu_torch.utils.utils import setup_logging
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)

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


def build_parser():
    parser = argparse.ArgumentParser(description='Joint workflow optimization (PyTorch port)')
    parser.add_argument('--nip', default='UNet')
    parser.add_argument('--cam', dest='cameras', action='append', default=None,
                        help='camera/dataset name (repeat for multiple cameras)')
    parser.add_argument('--data', default=None)
    parser.add_argument('--loss', dest='loss_metric', default='L2',
                        choices=['L2', 'L1', 'SSIM'], help='NIP loss metric')
    parser.add_argument('--scratch', action='store_true',
                        help='train the NIP from scratch (skip pre-trained weights)')
    parser.add_argument('--jpeg_mode', default='soft',
                        choices=['soft', 'sin', 'harmonic', 'libjpeg'],
                        help='dJPEG rounding approximation for the channel')
    parser.add_argument('--split', default='120:30:4')
    parser.add_argument('--epochs', type=int, default=1001)
    parser.add_argument('--patch', type=int, default=64, help='RAW patch size')
    parser.add_argument('--batch', type=int, default=10)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--dir', default='./data/m', help='output root')
    parser.add_argument('--nip-dir', default='./data/models/nip', help='NIP snapshots root')
    parser.add_argument('--jpeg', default=None,
                        help='JPEG channel: quality Q or range Q1,Q2')
    parser.add_argument('--jpeg-trainable', action='store_true',
                        help="make the channel JPEG's quantization tables trainable; "
                             'optimize them with --train dcn weighted by --lc')
    parser.add_argument('--dcn', default=None,
                        help='DCN channel: a codec directory or preset (e.g. 32c)')
    parser.add_argument('--ds', default='pool', choices=['pool', 'bilinear', 'none'],
                        help='channel downsampling')
    parser.add_argument('--train', nargs='*', default=[],
                        help='components to fine-tune: nip dcn')
    parser.add_argument('--ln', nargs='*', type=float, default=[0.1],
                        help='NIP regularization λ sweep')
    parser.add_argument('--lc', nargs='*', type=float, default=[0.1],
                        help='DCN regularization λ sweep')
    parser.add_argument('--start', type=int, default=0, help='first repetition')
    parser.add_argument('--end', type=int, default=1, help='last repetition (exclusive)')
    parser.add_argument('--manip', default=None,
                        help='comma-separated manipulations, e.g. sharpen:1,gaussian')
    parser.add_argument('--fan', default=None, help='JSON with FAN hyper-params')
    parser.add_argument('--augment', action='store_true')
    parser.add_argument('--channel-dtype', default='float32', choices=['float32', 'bfloat16'],
                        help='distribution-channel compute dtype: the manipulations, the '
                             "pooling, the channel's output and the FAN's input")
    parser.add_argument('--channel-jpeg-dtype', default=None, choices=['float32', 'bfloat16'],
                        help='channel dJPEG compute dtype; bfloat16 runs the channel codec '
                             "in bfloat16 at 'default' precision (the plane form, not K1)")
    parser.add_argument('--manip-jpeg-dtype', default=None, choices=['float32', 'bfloat16'],
                        help="the 'jpeg' manipulation's compute dtype (as "
                             '--channel-jpeg-dtype)')
    parser.add_argument('--nip-params', default=None,
                        help="JSON with NIP constructor kwargs, e.g. \"{'kernel': 5}\"")
    parser.add_argument('--val-schedule', type=int, default=50)
    parser.add_argument('--overwrite', action='store_true')
    parser.add_argument('--device-data', action='store_true',
                        help='copy the training set to the device once and sample patches '
                             'there')
    parser.add_argument('--nan-check', action='store_true',
                        help='check gradients for NaNs on every step (waits for the device '
                             'each step; by default the check waits for validation)')
    ptrain.add_cli_args(parser)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging()
    if launch.launch_cli_ranks('neural_imaging_tpu_torch.cli.train_manipulation', argv, args,
                               args.batch):
        return
    parallel = ptrain.from_cli_args(args, batch_size=args.batch)
    try:
        _train(parser, args, parallel)
    finally:
        multihost.shutdown()


def _train(parser, args, parallel):

    if args.dcn is not None:
        distribution = {'downsampling': args.ds, 'compression': 'dcn',
                        'compression_params': {'dirname': args.dcn}}
    elif args.jpeg is not None:
        quality = ([int(q) for q in args.jpeg.split(',')] if ',' in args.jpeg
                   else int(args.jpeg))
        if args.jpeg_trainable and (not isinstance(quality, int)
                                    or args.jpeg_mode == 'libjpeg'):
            parser.error('--jpeg-trainable needs a scalar --jpeg quality (the tables '
                         'initialize from it) and a differentiable --jpeg_mode '
                         '(soft/sin/harmonic)')
        distribution = {'downsampling': args.ds, 'compression': 'jpeg',
                        'compression_params': {'quality': quality, 'codec': args.jpeg_mode,
                                               'trainable': args.jpeg_trainable}}
    else:
        distribution = {'downsampling': args.ds, 'compression': 'none'}

    trainable = set(args.train)
    manipulations = args.manip.split(',') if args.manip else None
    fan_args = parse_json_arg(args.fan)
    nip_params = parse_json_arg(args.nip_params)

    n_images, v_images, val_n_patches = parse_split(args.split)
    load = 'y' if args.nip == 'ONet' else 'xy'
    ln_sweep = args.ln if 'nip' in trainable else [0.0]
    lc_sweep = args.lc if 'dcn' in trainable else [0.0]

    for cam in args.cameras or ['D90']:
        data = Dataset(args.data or cam, load=load, n_images=n_images, v_images=v_images,
                       val_rgb_patch_size=2 * args.patch, val_n_patches=val_n_patches)
        flow = None
        for run, ln, lc in itertools.product(range(args.start, args.end), ln_sweep, lc_sweep):
            print(f'\n# {cam} run {run}: λ_nip={ln} λ_dcn={lc} trainable={sorted(trainable)}')
            if flow is None:
                flow = ManipulationClassification(
                    args.nip, manipulations=manipulations, distribution=distribution,
                    fan_args=fan_args, trainable=trainable, raw_patch_size=args.patch,
                    loss_metric=args.loss_metric, nip_args=nip_params,
                    channel_dtype=args.channel_dtype, channel_jpeg_dtype=args.channel_jpeg_dtype,
                    manip_jpeg_dtype=args.manip_jpeg_dtype, device=args.device)
            else:
                flow.reinitialize()
            training = {
                'camera_name': cam,
                'use_pretrained_nip': args.nip != 'ONet' and not args.scratch,
                'patch_size': args.patch,
                'batch_size': args.batch,
                'n_epochs': args.epochs,
                'learning_rate': args.lr,
                'lambda_nip': ln,
                'lambda_dcn': lc,
                'run_number': run,
                'augment': args.augment,
                'validation_schedule': args.val_schedule,
            }
            train_manipulation_nip(flow, training, data,
                                   directories={'root': args.dir, 'nip_snapshots': args.nip_dir},
                                   overwrite=args.overwrite, nan_check=args.nan_check,
                                   device_data=args.device_data, parallel=parallel)


if __name__ == '__main__':
    main()
