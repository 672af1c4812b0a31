"""
Host helpers of the trainer: the package's logger, number checks and the
formatting of numbers, patch shapes and arguments, and the lookup of a
logged metric by its key path. Copy of the parts of
``neural_imaging_tpu/utils/utils.py`` that the trainer uses, so the port's
logs read as the JAX package's.
"""
import logging
import math
import numbers
import sys

import numpy as np

_LOG_FORMAT = '%(asctime)s | %(levelname)-7s | %(name)s:%(funcName)s:%(lineno)d - %(message)s'

logger = logging.getLogger('neural_imaging_tpu_torch')


def setup_logging(level=logging.INFO, stream=None):
    """Compact console logging for the package's logger."""
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(_LOG_FORMAT, datefmt='%H:%M:%S'))
    logger.handlers.clear()
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def is_number(value):
    """True for ints, floats and numpy numbers; False for bools."""
    if isinstance(value, bool):
        return False
    if isinstance(value, numbers.Number):
        return True
    return isinstance(value, np.generic) and np.issubdtype(type(value), np.number)


def format_number(value, sig=3):
    """A number with about ``sig`` significant digits; integers as integers."""
    if value is None:
        return 'None'
    if not is_number(value):
        return str(value)
    if float(value) == int(value) and abs(value) < 1e6:
        return str(int(value))
    if value == 0:
        return '0'
    magnitude = int(math.floor(math.log10(abs(value))))
    digits = max(0, sig - 1 - magnitude)
    return '{:.{d}f}'.format(value, d=min(digits, 12))


def format_patch_shape(shape):
    if shape is None:
        return '(any)'
    return '(' + ', '.join('?' if s is None else str(s) for s in tuple(shape)) + ')'


def join_args(d):
    return ', '.join(f'{k}={v}' for k, v in d.items())


def levenshtein(a, b):
    """Edit distance between two strings (for fuzzy CLI option matching)."""
    if len(a) < len(b):
        a, b = b, a
    previous = list(range(len(b) + 1))
    for i, ca in enumerate(a):
        current = [i + 1]
        for j, cb in enumerate(b):
            current.append(min(previous[j + 1] + 1, current[j] + 1, previous[j] + (ca != cb)))
        previous = current
    return previous[-1]


def match_option(value, options, threshold=3):
    """Fuzzy-match a CLI value against valid options: the value itself, its
    only prefix match, or the nearest within ``threshold`` edits; raises
    ValueError otherwise."""
    options = list(options)
    if value in options:
        return value
    prefixed = [o for o in options if o.startswith(value)]
    if len(prefixed) == 1:
        return prefixed[0]
    distances = sorted((levenshtein(value, o), o) for o in options)
    if distances and distances[0][0] <= threshold:
        return distances[0][1]
    raise ValueError(f'Could not match option {value!r}; available: {options}')


def get(dictionary, path, sep='/'):
    """Recursive dict lookup with a path string, e.g. get(d, 'performance/psnr/validation');
    empty segments are skipped."""
    node = dictionary
    for key in path.split(sep):
        if not key:
            continue
        node = node[key]
    return node
