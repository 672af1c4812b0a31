"""
IJG quantization tables (public Annex-K standard), the quality scaling law
and the quality estimate of a table. Copy of the table part of
``neural_imaging_tpu/compression/jpeg_helpers.py`` without its PIL-based
libjpeg bridge.
"""
import numpy as np

K1_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32)

K2_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], dtype=np.float32)


def jpeg_qtable(quality, channel=0):
    """DCT quantization matrix for an IJG quality level (1-100)."""
    quality = float(np.clip(quality, 1, 100))
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    t = K1_LUMA if channel == 0 else K2_CHROMA
    t = np.floor((t * scale + 50.0) / 100.0)
    return np.clip(t, 1, 255).astype(np.float32)


def jpeg_qf_estimation(q_mtx, channel=0):
    """The quality factor whose IJG table is nearest ``q_mtx`` (mean |diff|)."""
    q_mtx = np.asarray(q_mtx)
    errors = [np.mean(np.abs(jpeg_qtable(qf, channel) - q_mtx)) for qf in range(1, 101)]
    return int(np.argmin(errors)) + 1
