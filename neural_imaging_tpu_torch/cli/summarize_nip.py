"""
NIP training statistics across cameras and pipelines: the counterpart of the
repository's ``summarize_nip.py``, with its flags. It reads the training
logs (``progress.json``) on the host and runs nothing on a device.

    python -m neural_imaging_tpu_torch.cli.summarize_nip [--dir data/models/nip] [--n 1]
"""
import argparse

from neural_imaging_tpu_torch.utils import results_data


def build_parser():
    parser = argparse.ArgumentParser(description='NIP training stats table (PyTorch port)')
    parser.add_argument('--dir', dest='dirname', default='./data/models/nip')
    parser.add_argument('--n', type=int, default=1, help='average over last n validations')
    return parser


def main(argv=None):
    """Prints ``results_data.nip_stats`` and returns it."""
    args = build_parser().parse_args(argv)
    table = results_data.nip_stats(args.dirname, avg_last_n_runs=args.n)
    if table.empty:
        print(f'No trained NIP models found under {args.dirname}')
    else:
        print(table.to_string(index=False))
    return table


if __name__ == '__main__':
    main()
