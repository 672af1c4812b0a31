"""
A/B comparison of two ISPs on one validation patch: the counterpart of the
repository's ``diff_nip.py``, with its flags, plus ``--device`` (default
``cuda``; ``cpu`` must be asked for).

    python -m neural_imaging_tpu_torch.cli.diff_nip --a INet --b UNet --cam QualityRef \\
        --data DIR [--patch 128] [--image 0]

Each of ``--a`` and ``--b`` is a class name (with the camera's snapshot
under ``data/models/nip`` where there is one) or a checkpoint directory.
Prints the numbers that the reference's figure (``utils/imdiff.py::
compare_ab_ref``) puts in its titles: A's and B's PSNR and SSIM against the
reference patch. The figure (difference maps, FFT spectra) needs
matplotlib and is not drawn.
"""
import argparse

from neural_imaging_tpu_torch.cli.test_nip import NO_FIGURE, load_nip
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.utils import metrics


def build_parser():
    parser = argparse.ArgumentParser(description='A/B compare two ISPs (PyTorch port)')
    parser.add_argument('--a', required=True, help='model A: class name or checkpoint dir')
    parser.add_argument('--b', default=None, help='model B: class name or checkpoint dir')
    parser.add_argument('--cam', default='D90')
    parser.add_argument('--data', default=None)
    parser.add_argument('--patch', type=int, default=128)
    parser.add_argument('--image', type=int, default=0)
    parser.add_argument('--extras', action='store_true',
                        help='FFT spectra (figure only: not drawn)')
    parser.add_argument('--out', default='diff_nip.png', help='figure path (not written)')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None):
    """Returns {'A': (psnr, ssim)[, 'B': (psnr, ssim)]} against the reference."""
    args = build_parser().parse_args(argv)
    data = Dataset(args.data or args.cam, n_images=0, v_images=-1,
                   val_rgb_patch_size=2 * args.patch, val_n_patches=1)
    vx, vy = data.next_validation_batch(args.image, 1)
    scores = {}
    for label, spec in (('A', args.a), ('B', args.b)):
        if spec is None:
            continue
        model, _ = load_nip(spec, args.cam, args.device)
        out = model.process(vx)[0].cpu().numpy()
        scores[label] = (metrics.psnr(vy[0], out), metrics.ssim(vy[0], out))
        print(f'{label}: {scores[label][0]:.1f} dB / {scores[label][1]:.3f}')
    print(NO_FIGURE)
    return scores


if __name__ == '__main__':
    main()
