"""
Bayer helpers of the reference: where each plane of an (R, G1, G2, B) stack
sits in its 2x2 cell for each CFA pattern, and the mosaic that samples RGB
into such a stack. The ISPs that develop a stack are ``isp_<model>.py``
(``by_name.isp``).
"""
import torch

# GBRG: where each plane of an (R, G1, G2, B) stack sits in its 2x2 cell, and
# which RGB channel it samples
CFA_OFFSETS = {'gbrg': {'R': (1, 0), 'G1': (0, 0), 'G2': (1, 1), 'B': (0, 1)},
               'rggb': {'R': (0, 0), 'G1': (0, 1), 'G2': (1, 0), 'B': (1, 1)},
               'bggr': {'R': (1, 1), 'G1': (0, 1), 'G2': (1, 0), 'B': (0, 0)}}
PLANES = ('R', 'G1', 'G2', 'B')
PLANE_RGB = {'R': 0, 'G1': 1, 'G2': 1, 'B': 2}


def mosaic(rgb, cfa='gbrg'):
    """(N, 3, H, W) RGB → (N, 4, H/2, W/2) Bayer stack sampled per the CFA."""
    planes = []
    for plane in PLANES:
        r, c = CFA_OFFSETS[cfa][plane]
        planes.append(rgb[:, PLANE_RGB[plane], r::2, c::2])
    return torch.stack(planes, dim=1)
