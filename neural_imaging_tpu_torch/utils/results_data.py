"""
The plain-text confusion table that the re-validation CLI prints: the port's
copy of ``confusion_to_text`` of ``neural_imaging_tpu/utils/results_data.py``,
without pandas (which that module imports and the GPU machine lacks). The
reference's TeX form of the table is not ported.
"""
import numpy as np


def confusion_to_text(conf, labels, title='accuracy'):
    """A confusion matrix (rows true, columns predicted, in percent) as the
    reference's plain text: a title line with the mean of the diagonal, a
    header of each label's first letter and one row per label."""
    conf = np.asarray(conf)
    if conf.ndim != 2:
        raise ValueError(f'expected a 2-D array, got ndim={conf.ndim}')
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
