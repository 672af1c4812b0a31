"""
Develop RAW images with the PyTorch port: the counterpart of the repository's
``develop_images.py``, with its flags, plus ``--device`` (default ``cuda``;
``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.develop_images --dir RAWS --pipeline UNet --cam QualityRef

``--pipeline auto`` / ``manual`` develop with the scratch pipeline (bilinear,
no brightness correction; ``raw.process``), a NIP class (INet, UNet, DNet,
ClassicISP) with that camera ISP: its snapshot from ``--model-dir``, else
``data/models/nip/<cam>/<model_code>/<scoped_name>``, else its initial
weights (with a warning). A NIP develops a file's whole RGGB stack in one
forward on the device under ``torch.inference_mode()``, or with ``--devices
n`` in n row bands, band i on card i (``parallel/spatial.py``: the
reference's spatial sharding of one image's height; with ``--device cpu``
n bands on the CPU; 'auto' is every card). Each file becomes
``<out>/<stem>_<pipeline or class>.png``.
"""
import argparse
import os
import time

import torch

from neural_imaging_tpu_torch.cli.train_prepare_training_set import raw_files
from neural_imaging_tpu_torch.data import png, raw
from neural_imaging_tpu_torch.parallel import spatial
from neural_imaging_tpu_torch.parallel.launch import rank_devices
from neural_imaging_tpu_torch.parallel.train import count_devices
from neural_imaging_tpu_torch.utils.device import resolve_device
from neural_imaging_tpu_torch.utils.utils import logger, setup_logging


def build_parser():
    parser = argparse.ArgumentParser(description='Batch-develop RAW images (PyTorch port)')
    parser.add_argument('--dir', dest='data_dir', required=True)
    parser.add_argument('--out', default=None)
    parser.add_argument('--pipeline', default='auto',
                        help="'auto', 'manual', or a NIP class (INet/UNet/DNet/ClassicISP)")
    parser.add_argument('--model-dir', default=None, help='trained NIP checkpoint dir')
    parser.add_argument('--cam', default=None, help='camera name for NIP checkpoints')
    parser.add_argument('--devices', default=None,
                        help="develop a NIP's image in row bands over devices: an int (the "
                             "first n cards, or n bands on --device cpu), 'auto' (every "
                             "card) or 'none' (default, the whole image on one device)")
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def load_nip(name, model_dir, cam, device):
    """The NIP class ``name`` at its defaults, its snapshot loaded from
    ``model_dir`` or the camera's default directory where there is one."""
    from neural_imaging_tpu_torch.models import pipelines
    model = getattr(pipelines, name)(patch_size=None, device=device)
    ckpt = model_dir
    if ckpt is None and cam:
        ckpt = os.path.join('data/models/nip', cam, model.model_code, model.scoped_name)
    if ckpt and os.path.isdir(ckpt):
        model.load_model(ckpt)
    else:
        logger.warning('no checkpoint found — developing with the initialized model')
    return model


def develop_stack(model, stack, devices=None):
    """A (h, w, 4) RGGB stack → (2h, 2w, 3) uint8 RGB through ``model``, in
    one forward on its device, or in bands over ``devices``
    (``spatial.develop_image``); float32, clipped and rounded as the
    reference."""
    with torch.inference_mode():
        if devices and len(devices) > 1:
            developed = spatial.develop_image(model, stack, devices)
        else:
            developed = model.process(stack[None])[0, :2 * stack.shape[0]]
        return (developed.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()


def band_devices(spec, device):
    """The devices of ``--devices``: None for one; n bands on the CPU or the
    first n cards ('auto': every card); more cards than the machine has is
    an error."""
    if spec in (None, 'none', ''):
        return None
    n = count_devices(spec, device)
    return rank_devices(device, n) if n > 1 else None


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()
    devices = (band_devices(args.devices, args.device)
               if args.pipeline not in ('auto', 'manual') else None)
    device = resolve_device(args.device)
    out_dir = args.out or args.data_dir
    os.makedirs(out_dir, exist_ok=True)
    files = raw_files(args.data_dir)
    if not files:
        logger.warning('No RAW files found in %s', args.data_dir)
        return []

    model = None
    if args.pipeline not in ('auto', 'manual'):
        model = load_nip(args.pipeline, args.model_dir, args.cam, device)
        if devices:
            logger.info('Developing in %d row bands over %s', len(devices), devices)
    suffix = args.pipeline if model is None else model.class_name

    written = []
    for filename, stem in files:
        t0 = time.perf_counter()
        path = os.path.join(args.data_dir, filename)
        if args.pipeline == 'auto':
            rgb = raw.process_auto(path, device=device)
        elif args.pipeline == 'manual':
            rgb = raw.to_uint8(raw.process(path, demosaicing='bilinear', brightness=None,
                                           device=device))
        else:
            stack, *_ = raw.unpack(path)
            rgb = develop_stack(model, stack, devices)
        out_path = os.path.join(out_dir, f'{stem}_{suffix}.png')
        png.write_png(out_path, rgb)
        written.append(out_path)
        logger.info('%s -> %s in %.2f s', filename, out_path, time.perf_counter() - t0)
    return written


if __name__ == '__main__':
    main()
