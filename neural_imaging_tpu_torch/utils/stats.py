"""
Detection statistics (accuracy, TPR, ROC, AUC), codebook histograms and
entropy, and moving averages: copy of ``neural_imaging_tpu/utils/stats.py``
(numpy and scipy; the same call signatures and values).
"""
import numpy as np
from scipy import stats as sstats

# numpy < 2 names the trapezoidal rule trapz
_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def span(negative, positive, bins=100):
    lo = min(positive.min(), negative.min()) - 1e-6
    hi = max(positive.max(), negative.max()) + 1e-6
    return np.linspace(lo, hi, bins)


def detection_accuracy(positive, negative, bins=100, return_index=False):
    """Best threshold accuracy 0.5*(P(pos>=t) + P(neg<t)) over a threshold sweep."""
    if isinstance(bins, int):
        bins = span(negative, positive, bins)
    pos = np.asarray(positive).reshape(-1, 1)
    neg = np.asarray(negative).reshape(-1, 1)
    t = np.asarray(bins).reshape(1, -1)
    accuracies = 0.5 * (np.mean(pos >= t, axis=0) + np.mean(neg < t, axis=0))
    best = int(np.argmax(accuracies))
    return (accuracies[best], best) if return_index else (accuracies[best], bins[best])


def true_positive_rate(positive, negative, fpr=0.01):
    thresh = np.percentile(negative, 100 * (1 - fpr))
    return np.mean(positive >= thresh)


def roc(positive, negative, bins=100):
    """TPR/FPR curves over a descending threshold sweep (so both start at 0)."""
    thresholds = span(negative, positive, bins)[::-1]
    pos = np.asarray(positive).reshape(-1, 1)
    neg = np.asarray(negative).reshape(-1, 1)
    tpr = np.mean(pos >= thresholds.reshape(1, -1), axis=0)
    fpr = np.mean(neg >= thresholds.reshape(1, -1), axis=0)
    return list(tpr), list(fpr)


def auc(positive, negative, bins=100):
    tpr, fpr = roc(positive, negative, bins)
    if (tpr[0], fpr[0]) != (0, 0) or (tpr[-1], fpr[-1]) != (1, 1):
        raise ValueError(
            f'Degenerate ROC sweep: endpoints ({tpr[0]}, {fpr[0]}) .. '
            f'({tpr[-1]}, {fpr[-1]}) — expected a (0,0) .. (1,1) curve; '
            'widen the threshold span')
    return _trapezoid(tpr, fpr)


def inlier_rate(candidates, reference, perc=0.05):
    lo, hi = np.percentile(reference, [100 * perc, 100 * (1 - perc)])
    return np.mean((candidates > lo) & (candidates < hi))


def corrcoeff(a, b):
    a = (a - np.mean(a)) / (1e-9 + np.std(a))
    b = (b - np.mean(b)) / (1e-9 + np.std(b))
    return np.mean(a * b)


def bin_edges(code_book):
    """Bin edges halfway between codebook centroids, padded with wide sentinels."""
    code_book = np.asarray(code_book, dtype=np.float64).reshape(-1)
    sentinel = 2 * np.abs(code_book).max()
    midpoints = 0.5 * (code_book[:-1] + code_book[1:])
    return np.concatenate(([-sentinel], midpoints, [sentinel]))


def hist(values, code_book, density=False):
    """Histogram of values quantized to centroids (not numpy bin edges).
    With ``density``, bin-width-normalized densities are rescaled to sum to 1
    (reference semantics — the sentinel bins are wide, so this is NOT the same
    as counts/total)."""
    f = np.histogram(np.asarray(values).ravel(), bins=bin_edges(code_book),
                     density=density)[0]
    return f / f.sum() if density else f


def entropy(samples, code_book=None):
    """Empirical entropy (bits) of samples quantized to a centroid codebook."""
    if code_book is None:
        code_book = np.arange(-255, 255, 1).reshape((-1,))
    counts = hist(samples, code_book).clip(min=1)
    probs = counts / counts.sum()
    return -np.sum(probs * np.log2(probs))


def kld_discrete(samples_a, samples_b, bins=25):
    cc = span(samples_a, samples_b, bins)
    p1 = hist(samples_a, cc, density=True).clip(min=1e-16)
    p2 = hist(samples_b, cc, density=True).clip(min=1e-16)
    return sstats.entropy(p1, p2)


def ma_gaussian(x, y, step_size=0.05, width=10):
    """Moving average with Gaussian weighting."""
    x, y = np.asarray(x), np.asarray(y)
    centers = np.arange(np.min(x), np.max(x) - 0.5 * step_size, step_size) \
        + 0.5 * step_size
    weights = np.exp(-(x[None, :] - centers[:, None]) ** 2 / (2 * width ** 2))
    averaged = (weights @ y) / weights.sum(axis=1)
    return centers, averaged


def ma_conv(x, n=10):
    """Moving average with a box filter (edge-padded)."""
    x = np.asarray(x)
    if len(x) == 0:
        return np.array([])
    if n == 0:
        n = len(x) // 10
    fn = 2 * n + 1
    return np.convolve(np.pad(x, n, 'edge'), np.ones((fn,)) / fn, mode='valid')


def ma_exp(x, alpha=0.1):
    """Exponential moving average."""
    x = np.asarray(x, dtype=np.float64)
    y = np.zeros_like(x)
    if len(x):
        y[0] = x[0]
        for i in range(1, x.shape[0]):
            y[i] = alpha * x[i] + (1 - alpha) * y[i - 1]
    return y
