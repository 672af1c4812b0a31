"""
Host image helpers: the counterpart of ``neural_imaging_tpu/utils/image.py``
for what the port uses of it and of OpenCV. :func:`resize_area` is
``cv2.resize(image, (size, size), interpolation=cv2.INTER_AREA)`` for a
shrinking resize: each output sample is the mean of the input samples its
cell covers, those at the cell's edges weighted by the fraction covered
(OpenCV's ``computeResizeAreaTab``, its weights rounded to float32 as there),
summed here in float64.
"""
import numpy as np


def _area_weights(src, dst):
    """(dst, src) matrix of OpenCV's INTER_AREA weights for shrinking src → dst."""
    scale = 1.0 / (dst / src)            # as cv::resize forms it from its inverse
    weights = np.zeros((dst, src))
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            weights[d, s1 - 1] = np.float32((s1 - f1) / cell)
        weights[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            weights[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return weights


def resize_area(batch, size):
    """INTER_AREA resize of an (h, w, c) image or an (n, h, w, c) batch to
    (size, size), float32; h and w at least ``size``."""
    batch = np.asarray(batch)
    h, w = batch.shape[-3:-1]
    if size > h or size > w:
        raise ValueError(f'resize_area only shrinks: {h}x{w} -> {size}x{size}')
    wy, wx = _area_weights(h, size), _area_weights(w, size)
    rows = np.einsum('yh,...hwc->...ywc', wy, batch.astype(np.float64))
    return np.einsum('...ywc,xw->...yxc', rows, wx).astype(np.float32)
