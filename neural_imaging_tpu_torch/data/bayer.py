"""
Bayer CFA layout constants: for each CFA pattern, the (row, col) offset of
R, G1, G2 and B within each 2x2 tile. Copy of the constants of
``neural_imaging_tpu/data/bayer.py`` that the filter functions need.
"""
CFA_OFFSETS = {
    'GBRG': {'R': (1, 0), 'G1': (0, 0), 'G2': (1, 1), 'B': (0, 1)},
    'RGGB': {'R': (0, 0), 'G1': (0, 1), 'G2': (1, 0), 'B': (1, 1)},
    'BGGR': {'R': (1, 1), 'G1': (0, 1), 'G2': (1, 0), 'B': (0, 0)},
    'GRBG': {'R': (0, 1), 'G1': (0, 0), 'G2': (1, 1), 'B': (1, 0)},
}
STACK_PLANES = ('R', 'G1', 'G2', 'B')
PLANE_RGB = {'R': 0, 'G1': 1, 'G2': 1, 'B': 2}
