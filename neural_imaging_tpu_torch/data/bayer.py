"""
Bayer CFA layout and the simulation of a mosaic: copy of the constants and of
``stack_bayer``, ``merge_bayer`` and ``mosaic_flat`` of
``neural_imaging_tpu/data/bayer.py``.

For each CFA pattern, the (row, col) offset of R, G1, G2 and B within each
2x2 tile. A Bayer *stack* is the RAW representation: (h/2, w/2, 4) with
channels ordered R, G1, G2, B whatever the pattern.
"""
import numpy as np

CFA_OFFSETS = {
    'GBRG': {'R': (1, 0), 'G1': (0, 0), 'G2': (1, 1), 'B': (0, 1)},
    'RGGB': {'R': (0, 0), 'G1': (0, 1), 'G2': (1, 0), 'B': (1, 1)},
    'BGGR': {'R': (1, 1), 'G1': (0, 1), 'G2': (1, 0), 'B': (0, 0)},
    'GRBG': {'R': (0, 1), 'G1': (0, 0), 'G2': (1, 1), 'B': (1, 0)},
}
STACK_PLANES = ('R', 'G1', 'G2', 'B')
PLANE_RGB = {'R': 0, 'G1': 1, 'G2': 1, 'B': 2}


def _offsets(cfa_pattern):
    cfa_pattern = cfa_pattern.upper()
    if cfa_pattern not in CFA_OFFSETS:
        raise ValueError(f'Unsupported CFA pattern: {cfa_pattern}')
    return CFA_OFFSETS[cfa_pattern]


def stack_bayer(image_rgb, cfa_pattern):
    """Sample a (h, w, 3) RGB image into an RGGB stack (h/2, w/2, 4) per the CFA."""
    off = _offsets(cfa_pattern)
    planes = [image_rgb[off[p][0]::2, off[p][1]::2, PLANE_RGB[p]] for p in STACK_PLANES]
    return np.stack(planes, axis=-1)


def merge_bayer(bayer_stack, cfa_pattern):
    """Scatter an RGGB stack (h/2, w/2, 4) (or a batch of one) into a sparse
    full-resolution (h, w, 3) RGB mosaic."""
    if bayer_stack.ndim == 4:
        if bayer_stack.shape[0] != 1:
            raise ValueError('4-D arrays are not supported!')
        bayer_stack = bayer_stack[0]
    if bayer_stack.ndim != 3:
        raise ValueError('Unsupported array shape!')
    off = _offsets(cfa_pattern)
    h, w = bayer_stack.shape[:2]
    out = np.zeros((2 * h, 2 * w, 3), dtype=bayer_stack.dtype)
    for i, p in enumerate(STACK_PLANES):
        r, c = off[p]
        out[r::2, c::2, PLANE_RGB[p]] = bayer_stack[:, :, i]
    return out


def mosaic_flat(image_rgb, cfa_pattern):
    """Full-resolution single-channel Bayer mosaic (h, w) sampled from RGB."""
    off = _offsets(cfa_pattern)
    out = np.zeros(image_rgb.shape[:2], dtype=image_rgb.dtype)
    for p in STACK_PLANES:
        r, c = off[p]
        out[r::2, c::2] = image_rgb[r::2, c::2, PLANE_RGB[p]]
    return out
