"""
Results aggregation: tables over the JSON training-log trees, plain-text and
CSV table renderers, result persistence and a pattern-based result cache.
Port of ``neural_imaging_tpu/utils/results_data.py``.

The reference builds pandas DataFrames; here each builder returns a
:class:`~neural_imaging_tpu_torch.utils.table.Table` with the same columns,
rows and values (pandas is not on the GPU machine). The TeX forms of the
tables are not ported (``convert_table(fmt='tex')`` and
``confusion_to_text(fmt='tex')`` raise), and ``render_tex`` refuses as the
reference does.
"""
import ast
import glob as globlib
import json
import os
from collections import OrderedDict
from pathlib import Path
from string import Formatter

import numpy as np

from neural_imaging_tpu_torch.utils import fsutil, jsonlog
from neural_imaging_tpu_torch.utils.table import Table
from neural_imaging_tpu_torch.utils.utils import join_args, logger

ROOT_DIRNAME = './data/m'


class DefaultFormatter(Formatter):
    """Formatter that substitutes a default (e.g. '*') for missing keys."""

    def __init__(self, default=None):
        self.default = default

    def get_value(self, key, args, kwds):
        if isinstance(key, str):
            if key in kwds:
                return kwds[key]
            return f'{{{key}}}' if self.default is None else self.default
        return Formatter.get_value(self, key, args, kwds)


def _get(d, dotted_path, default=None):
    """A nested lookup by a dot-separated path; ``default`` where a key is missing."""
    try:
        for key in dotted_path.split('.'):
            if key:
                d = d[key]
        return d
    except (KeyError, TypeError):
        return default


def _last(seq):
    """Last element of a possibly-missing/empty metric history (NaN otherwise —
    e.g. a frozen NIP logs an empty validation list)."""
    if seq is None or len(seq) == 0:
        return np.nan
    return seq[-1]


def autodetect_cameras(dirname):
    """List known cameras based on available NIP snapshot directories."""
    counter = 5
    while counter > 0 and not os.path.exists(os.path.join(dirname, 'models', 'nip')):
        dirname = os.path.split(dirname)[0]
        counter -= 1
    if counter == 0:
        raise ValueError(f'{dirname} does not seem to be a valid results directory')
    return fsutil.listdir(os.path.join(dirname, 'models', 'nip'), '.*', dirs_only=True)


def nip_stats(dirname, avg_last_n_runs=1):
    """Table (pipeline, camera, psnr, ssim) of the NIP training summaries, a
    row per camera and pipeline: the mean of the last ``avg_last_n_runs``
    validation values of the first ``progress.json`` found."""
    rows = []
    for camera in sorted(os.listdir(dirname)):
        cam_dir = os.path.join(dirname, camera)
        if not os.path.isdir(cam_dir):
            continue
        for pipe in sorted(os.listdir(cam_dir)):
            candidates = sorted(Path(os.path.join(cam_dir, pipe)).glob('**/progress.json'))
            if not candidates:
                continue
            with open(candidates[0]) as f:
                ts = json.load(f)
            data = ts if 'psnr' in ts else ts.get('performance', {})
            rows.append({
                'pipeline': pipe,
                'camera': camera,
                'psnr': float(np.mean(_get(data, 'psnr.validation', [np.nan])[-avg_last_n_runs:])),
                'ssim': float(np.mean(_get(data, 'ssim.validation', [np.nan])[-avg_last_n_runs:])),
            })
    return Table(rows, ['pipeline', 'camera', 'psnr', 'ssim'])


def manipulation_metrics(nip_models, cameras, root_dir=ROOT_DIRNAME):
    """Table of the manipulation-classification metrics, a row per
    ``training.json`` of each camera / NIP / experiment directory."""
    nip_models = [nip_models] if isinstance(nip_models, str) else nip_models
    cameras = cameras or fsutil.listdir(root_dir, '.', dirs_only=True)

    rows = []
    for camera in cameras:
        models = nip_models or fsutil.listdir(os.path.join(root_dir, camera), '.',
                                              dirs_only=True)
        for nip in models:
            find_dir = os.path.join(root_dir, camera, nip)
            if not os.path.isdir(find_dir):
                continue
            for ed in fsutil.listdir(find_dir, '.*', dirs_only=True):
                exp_dir = os.path.join(find_dir, ed)
                for jf in sorted(str(f) for f in Path(exp_dir).glob('**/training.json')):
                    with open(jf) as f:
                        data = json.load(f)
                    rows.append({
                        'camera': camera,
                        'nip': nip,
                        'ln': ed,
                        'source': jf.replace(find_dir, '').replace('training.json', ''),
                        'psnr': _last(_get(data, 'nip.performance.psnr.validation', None)),
                        'ssim': _last(_get(data, 'nip.performance.ssim.validation', None)),
                        'accuracy': _last(_get(
                            data, 'forensics.performance.accuracy.validation', None)),
                    })
    return Table(rows, ['camera', 'nip', 'ln', 'source', 'psnr', 'ssim', 'accuracy'])


def manipulation_progress(cases, root_dir=ROOT_DIRNAME):
    """(Table of the per-validation-step progress of the selected (camera,
    nip, exp, rep) cases, their labels)."""
    cases = cases or [('D90', 'INet', 'ln-0.1000/fixed-codec', 0)]
    rows, labels = [], []
    last = (None, None, None, None)

    for camera, nip_model, ed, rep in cases:
        camera = camera or last[0]
        nip_model = nip_model or last[1]
        ed = ed or last[2]
        rep = rep if rep is not None else last[3]

        filename = os.path.join(root_dir, camera, nip_model, ed, f'{rep:03d}',
                                'training.json')
        if not os.path.isfile(filename):
            logger.warning('Could not find file %s', filename)
            continue
        labels.append(f'{camera} ({nip_model}/{ed}/{rep})')
        with open(filename) as f:
            data = json.load(f)

        def match_length(y, x):
            x = list(x) if x else [np.nan]
            x = x[:len(y)]
            x += [x[-1]] * (len(y) - len(x))
            return x

        d_psnr = _get(data, 'nip.performance.psnr.validation', [])
        d_ssim = _get(data, 'nip.performance.ssim.validation', [])
        d_acc = _get(data, 'forensics.performance.accuracy.validation', [])

        psnr, ssim = match_length(d_acc, d_psnr), match_length(d_acc, d_ssim)
        rows += [{'camera': camera, 'nip': nip_model, 'exp': ed, 'rep': rep, 'step': step,
                  'psnr': psnr[step], 'ssim': ssim[step], 'accuracy': d_acc[step]}
                 for step in range(len(d_acc))]
        last = (camera, nip_model, ed, rep)

    if not labels:
        raise RuntimeError('Empty dataframe! Double check experimental scenario!')
    return Table(rows, ['camera', 'nip', 'exp', 'rep', 'step', 'psnr', 'ssim',
                        'accuracy']), labels


def manipulation_summary(dirname):
    """Table of the last values of every ``training.json`` found under a directory."""
    rows = []
    for filename in Path(dirname).glob('**/training.json'):
        with open(str(filename)) as f:
            data = json.load(f)
        default = [np.nan]
        path_components = fsutil.split(os.path.relpath(str(filename), dirname))[:-1]
        rows.append({
            'scenario': os.path.join(*path_components[:-1]) if len(path_components) > 1 else '',
            'run': int(path_components[-1]) if path_components and
                   path_components[-1].isdigit() else 0,
            'accuracy': (_get(data, 'forensics.performance.accuracy.validation', default)
                         or default)[-1],
            'nip_ssim': (_get(data, 'nip.performance.ssim.validation', default) or default)[-1],
            'nip_psnr': (_get(data, 'nip.performance.psnr.validation', default) or default)[-1],
            'dcn_ssim': (_get(data, 'codec.performance.ssim.validation', default) or default)[-1],
            'dcn_entropy': (_get(data, 'codec.performance.entropy.validation', default)
                            or default)[-1],
        })
    return Table(rows, ['scenario', 'run', 'accuracy', 'nip_ssim', 'nip_psnr', 'dcn_ssim',
                        'dcn_entropy'])


def confusion_data(run=None, root_dir=ROOT_DIRNAME):
    """All confusion matrices found under a directory, keyed by normalized path."""
    confusion = OrderedDict()
    if run is None:
        logger.info('Using the first found repetition of the experiment')
        run = 0
    for jf in sorted(str(f) for f in Path(root_dir).glob('**/training.json')):
        if f'/{run:03d}/' not in jf + '/':
            continue
        with open(jf) as f:
            data = json.load(f)
        classes = _get(data, 'summary.Classes', '[]')
        if isinstance(classes, str):
            try:
                classes = ast.literal_eval(classes)
            except (ValueError, SyntaxError):
                classes = []
        key = os.path.relpath(os.path.split(jf)[0], root_dir).replace(f'/{run:03d}', '')
        confusion[key] = {
            'data': np.array(_get(data, 'forensics.performance.confusion', [])),
            'labels': classes,
        }
    return confusion


# ------------------------------------------------------------------------------------
# Table renderers
# ------------------------------------------------------------------------------------

def confusion_to_text(conf, labels, title='accuracy', fmt='txt'):
    """A confusion matrix (rows true, columns predicted, in percent) as plain
    text: a title line with the mean of the diagonal, a header of each
    label's first letter and one row per label. The TeX form is not ported."""
    conf = np.asarray(conf)
    if conf.ndim != 2:
        raise ValueError(f'expected a 2-D array, got ndim={conf.ndim}')
    if fmt == 'tex':
        raise NotImplementedError('the TeX form of the confusion table is not ported; '
                                  "use fmt='txt'")
    if fmt != 'txt':
        raise ValueError('Invalid format! Only `tex` and `txt` are supported.')

    n = conf.shape[0]
    width = max(len(x) for x in labels)
    out = [f'# {title} (acc={np.mean(np.diag(conf)):.1f})\n', ' ' * width]
    out += [f'{labels[i][0]:>4}' for i in range(n)]
    out.append('\n')
    for i in range(n):
        out.append(f'{labels[i]:>{width}}')
        out += [f'{conf[i][j]:4.0f}' for j in range(n)]
        out.append('\n')
    return ''.join(out)


def convert_table(conf, labels, dim_labels='c\\r', title=None, fmt='txt', dec=0,
                  color1='cyan', color0='white', labels_rows=None):
    """Render a 2-D array as txt / csv, or as a Table (``fmt='df'``: the row
    labels in a first column named ``dim_labels``). The TeX form is not
    ported."""
    conf = np.asarray(conf)
    if conf.ndim != 2:
        raise ValueError(f'expected a 2-D array, got ndim={conf.ndim}')
    if '\\' not in dim_labels:
        raise ValueError("dim_labels must contain a backslash separating the "
                         "row/column axis names, e.g. 'True\\Predicted'")

    n, m = conf.shape
    labels_rows = labels_rows or labels
    width = max(len(str(x)) + 2 + dec for x in list(labels) + [dim_labels])

    if fmt == 'df':
        values = conf.round(dec)
        return Table([{dim_labels: labels_rows[i], **dict(zip(labels, values[i]))}
                      for i in range(n)], [dim_labels, *labels])

    out = []
    if fmt == 'tex':
        raise NotImplementedError("the TeX form of the table is not ported; use fmt='txt' "
                                  "or 'csv'")
    if fmt == 'txt':
        out.append('\n')
        if title is not None:
            out.append(f'#{title}\n')
        out.append(f'{dim_labels:>{width}}')
        out += [f'{labels[i]:>{width}}' for i in range(m)]
        out.append('\n')
        for i in range(n):
            out.append(f'{labels_rows[i]:>{width}}')
            out += ['{:{width}.{dec}f}'.format(conf[i][j], width=width, dec=dec)
                    for j in range(m)]
            out.append('\n')

    elif fmt == 'csv':
        out.append(f'{dim_labels}')
        out += [f',{labels[i]}' for i in range(m)]
        out.append('\n')
        for i in range(n):
            out.append(f'{labels_rows[i]}')
            out += [',{:.{dec}f}'.format(conf[i][j], dec=dec) for j in range(m)]
            out.append('\n')
    else:
        raise ValueError(f'Unknown format: {fmt}')

    return ''.join(out)


def render_tex(latex, format='fig', filename=None):
    """Render a LaTeX snippet (requires a TeX toolchain; gated)."""
    raise NotImplementedError(
        'TeX rendering requires the `latex`/`pdf2image` toolchain, which is not part '
        'of this environment. Use convert_table(..., fmt="txt"/"csv"/"df") instead.')


# ------------------------------------------------------------------------------------
# Result persistence
# ------------------------------------------------------------------------------------

def save(results, *, filename=None, prefix=None):
    """Save dict-like results as JSON or NPZ (by extension)."""
    if filename is None:
        filename = results['filename']
    if prefix is not None:
        filename = os.path.join(prefix, filename)
    os.makedirs(os.path.split(filename)[0] or '.', exist_ok=True)
    extension = os.path.splitext(filename)[-1].lower()
    if extension == '.npz':
        np.savez(filename, **results)
    elif extension == '.json':
        jsonlog.save_json(results, filename)
    else:
        raise ValueError(f'Unsupported format: {extension}')


def load(filename, prefix=None):
    """Load results from JSON or NPZ."""
    if prefix is not None:
        filename = os.path.join(prefix, filename)
    extension = os.path.splitext(filename)[-1].lower()
    if extension == '.npz':
        data = np.load(filename, allow_pickle=True)
        return {k: data[k] if data[k].ndim > 0 else data[k].item() for k in data.keys()}
    if extension == '.json':
        with open(filename) as f:
            return json.load(f)
    raise ValueError(f'Unsupported format: {extension}')


class ResultCache:
    """
    Pattern-based result store with wildcard search. Patterns are lists of path
    segments with ``{field}`` placeholders (named patterns resolve through
    config/result_patterns.json).
    """

    def __init__(self, pattern, prefix, patterns_file='config/result_patterns.json',
                 **kwargs):
        self.prefix = prefix
        self._pattern = pattern
        if isinstance(pattern, str):
            with open(patterns_file) as f:
                self.pattern = tuple(json.load(f)[pattern])
        else:
            self.pattern = tuple(pattern)
        self.kwargs = kwargs

    def set(self, **kwargs):
        self.kwargs.update(kwargs)

    def unset(self, fields):
        for f in ([fields] if isinstance(fields, str) else fields):
            del self.kwargs[f]

    def filename(self, **kwargs):
        """Unique filename for the current context (error if wildcards remain and
        more/fewer than one file matches)."""
        args = {**self.kwargs, **kwargs}
        try:
            filename = os.path.join(self.prefix, *[x.format(**args) for x in self.pattern])
            if '*' in filename:
                raise ValueError('Wildcards found - not a valid filename!')
            return filename
        except (KeyError, ValueError):
            pattern = self._wildcard_pattern(args)
            candidates = globlib.glob(pattern)
            if len(candidates) == 1:
                return candidates[0]
            raise ValueError(f'Search pattern [{pattern}] must match 1 file but '
                             f'matches {len(candidates)}')

    def load(self, **kwargs):
        return load(self.filename(**kwargs))

    def load_all(self, **kwargs):
        results = OrderedDict()
        for f in self.find(**kwargs):
            results[fsutil.strip_prefix(f, self.prefix)] = load(f)
        return results

    def save(self, results, overwrite=False, **kwargs):
        filename = self.filename(**kwargs)
        if not overwrite and os.path.isfile(filename):
            raise FileExistsError(f'File {filename} exists! Use overwrite=True if needed.')
        save(results, filename=filename)

    @staticmethod
    def format(pattern, prefix=None, patterns_file='config/result_patterns.json', **kwargs):
        if isinstance(pattern, str):
            with open(patterns_file) as f:
                pattern = json.load(f)[pattern]
        parts = [x.format(**kwargs) for x in pattern]
        return os.path.join(prefix, *parts) if prefix is not None else os.path.join(*parts)

    def _wildcard_pattern(self, args=None):
        fmt = DefaultFormatter('*')
        return os.path.join(self.prefix, *[fmt.format(x, **(args or {})) for x in self.pattern])

    def find(self, **kwargs):
        args = {**self.kwargs, **kwargs}
        pattern = self._wildcard_pattern(args)
        logger.info('*> %s', pattern)
        return sorted(globlib.glob(pattern))

    def __str__(self):
        fmt = DefaultFormatter()
        return '{} <- {}'.format(type(self).__name__,
                                 os.path.join(self.prefix,
                                              *[fmt.format(x, **self.kwargs)
                                                for x in self.pattern]))

    def __repr__(self):
        return '{}("{}","{}",{})'.format(type(self).__name__, self._pattern, self.prefix,
                                         join_args(self.kwargs))
