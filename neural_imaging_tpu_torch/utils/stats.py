"""Codebook histograms and empirical entropy: copy of ``bin_edges``, ``hist``
and ``entropy`` of ``neural_imaging_tpu/utils/stats.py``."""
import numpy as np


def bin_edges(code_book):
    """Bin edges halfway between codebook centroids, padded with wide sentinels."""
    code_book = np.asarray(code_book, dtype=np.float64).reshape(-1)
    sentinel = 2 * np.abs(code_book).max()
    midpoints = 0.5 * (code_book[:-1] + code_book[1:])
    return np.concatenate(([-sentinel], midpoints, [sentinel]))


def hist(values, code_book):
    """Counts of ``values`` quantized to the nearest centroid of ``code_book``."""
    return np.histogram(np.asarray(values).ravel(), bins=bin_edges(code_book))[0]


def entropy(samples, code_book=None):
    """Empirical entropy (bits) of samples quantized to a centroid codebook."""
    if code_book is None:
        code_book = np.arange(-255, 255, 1).reshape((-1,))
    counts = hist(samples, code_book).clip(min=1)
    probs = counts / counts.sum()
    return -np.sum(probs * np.log2(probs))
