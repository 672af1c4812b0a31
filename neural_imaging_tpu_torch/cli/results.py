"""
Aggregate manipulation-classification results from the JSON training logs:
the counterpart of the repository's ``results.py``, with its modes and
flags. It reads the logs on the host and runs nothing on a device.

    python -m neural_imaging_tpu_torch.cli.results df|auto|confusion [--dir data/m]

``df`` prints the summary table (``results_data.manipulation_summary``),
``auto`` the per-scenario means with the repetition counts, ``confusion``
each run's confusion matrix (``--fmt txt``; the TeX form is not ported and
``csv`` is refused as the reference refuses it). The reference's figures
need matplotlib or seaborn and are not drawn: ``auto`` says so in place of
its figure, and ``boxplot``, ``scatter`` and ``progress``, which draw a
figure only, print the table they would plot and exit with an error.
"""
import argparse
import os

import numpy as np

from neural_imaging_tpu_torch.utils import results_data
from neural_imaging_tpu_torch.utils.table import Table

FIGURE_MODES = ('boxplot', 'scatter', 'progress')


def build_parser():
    parser = argparse.ArgumentParser(description='Aggregate manipulation results (PyTorch port)')
    parser.add_argument('plot', choices=['boxplot', 'scatter', 'progress', 'confusion',
                                         'df', 'auto'])
    parser.add_argument('--dir', dest='root_dir', default='./data/m')
    parser.add_argument('--nip', nargs='*', default=None, help='NIP classes to include')
    parser.add_argument('--cam', nargs='*', default=None, help='cameras to include')
    parser.add_argument('--fmt', default='txt', choices=['txt', 'tex', 'csv'],
                        help='confusion output format')
    parser.add_argument('--run', type=int, default=0, help='repetition for confusion')
    parser.add_argument('--out', default=None, help='output figure path (not written)')
    return parser


def scenario_means(table):
    """The reference's ``auto`` table: a row per scenario (sorted), its
    repetition count ``reps`` and the mean of each numeric column (NaN
    skipped)."""
    numeric = table.numeric_columns()
    rows = [{'scenario': key, 'reps': len(group), **{c: group.mean(c) for c in numeric}}
            for key, group in table.groupby('scenario')]
    return Table(rows, ['scenario', 'reps', *numeric])


def main(argv=None):
    """Prints what the mode prints; returns its table (or the confusion data)."""
    args = build_parser().parse_args(argv)

    if args.plot == 'df':
        table = results_data.manipulation_summary(args.root_dir)
        print(table.to_string(index=False))
        return table

    if args.plot == 'auto':
        table = results_data.manipulation_summary(args.root_dir).sort_values('scenario')
        if table.empty:
            print(f'No results found under {args.root_dir}')
            return table
        print('figure: not drawn (the box plot of accuracy by scenario needs seaborn)')
        means = scenario_means(table)
        print(means.to_string(index=True))
        return means

    if args.plot == 'confusion':
        confusion = results_data.confusion_data(run=args.run, root_dir=args.root_dir)
        if not confusion:
            print(f'No confusion matrices found under {args.root_dir}')
            return confusion
        for key, entry in confusion.items():
            print(f'\n## {key}')
            print(results_data.confusion_to_text(100 * np.asarray(entry['data']),
                                                 entry['labels'], title=key, fmt=args.fmt))
        return confusion

    table = results_data.manipulation_metrics(args.nip, args.cam, root_dir=args.root_dir)
    if table.empty:
        print(f'No results found under {args.root_dir}')
        return table
    if args.plot == 'progress':
        cases = [(cam, nip, f'{ln}/{lc}', 0)
                 for cam in (args.cam or table.unique('camera'))
                 for nip in (args.nip or table.unique('nip'))
                 for ln in ['ln-0.1000', 'fixed-nip']
                 for lc in ['fixed-codec', 'lc-0.1000']
                 if os.path.isdir(os.path.join(args.root_dir, cam, nip, ln, lc))]
        table, labels = results_data.manipulation_progress(cases, root_dir=args.root_dir)
        print('\n'.join(labels))
    print(table.to_string(index=False))
    raise SystemExit(f'results {args.plot}: draws a figure only, which needs matplotlib '
                     '(not ported); its table is printed above')


if __name__ == '__main__':
    main()
