"""
The reference camera ISPs: INet (fixed Bayer scatter, TF-order
depth_to_space, reflect pad, demosaic conv, sRGB 1x1, two-layer tanh gamma,
straight-through clip) and ONet (identity on RGB). INet's weights are the
leaves of a JAX-format snapshot (HWIO kernels), read here with numpy.
"""
import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ops

# GBRG: where each plane of an (R, G1, G2, B) stack sits in its 2x2 cell, and
# which RGB channel it samples
CFA_OFFSETS = {'gbrg': {'R': (1, 0), 'G1': (0, 0), 'G2': (1, 1), 'B': (0, 1)},
               'rggb': {'R': (0, 0), 'G1': (0, 1), 'G2': (1, 0), 'B': (1, 1)},
               'bggr': {'R': (1, 1), 'G1': (0, 1), 'G2': (1, 0), 'B': (0, 0)}}
PLANES = ('R', 'G1', 'G2', 'B')
PLANE_RGB = {'R': 0, 'G1': 1, 'G2': 1, 'B': 2}
INET_LEAVES = ('demosaic', 'srgb', 'gamma_d1_kernel', 'gamma_d1_bias', 'gamma_d2_kernel',
               'gamma_d2_bias')


def scatter_kernel(cfa):
    """(12, 4, 1, 1): the stack's planes into depth_to_space(2) order."""
    k = np.zeros((12, 4, 1, 1), np.float32)
    for i, plane in enumerate(PLANES):
        r, c = CFA_OFFSETS[cfa][plane]
        k[(r * 2 + c) * 3 + PLANE_RGB[plane], i] = 1
    return k


def load_inet(npz_path, device):
    """INet's leaves {name: tensor} from a snapshot: kernels OIHW, biases as they are."""
    with np.load(npz_path) as z:
        return {k: (ops.hwio(z[k], device) if z[k].ndim == 4
                    else torch.as_tensor(z[k], dtype=torch.float32, device=device))
                for k in INET_LEAVES}


def inet(x, leaves, cfa='gbrg', kernel=5):
    """(N, 4, h, w) Bayer stack → (N, 3, 2h, 2w) RGB in [0, 1]."""
    up = torch.as_tensor(scatter_kernel(cfa), device=x.device)
    bayer = ops.depth_to_space(F.conv2d(x, up), 2)
    p = (kernel - 1) // 2
    rgb = F.conv2d(F.pad(bayer, (p, p, p, p), mode='reflect'), leaves['demosaic'])
    srgb = F.conv2d(rgb, leaves['srgb'])
    g = torch.tanh(F.conv2d(srgb, leaves['gamma_d1_kernel'], leaves['gamma_d1_bias']))
    return ops.st_clip(F.conv2d(g, leaves['gamma_d2_kernel'], leaves['gamma_d2_bias']))


def mosaic(rgb, cfa='gbrg'):
    """(N, 3, H, W) RGB → (N, 4, H/2, W/2) Bayer stack sampled per the CFA."""
    planes = []
    for plane in PLANES:
        r, c = CFA_OFFSETS[cfa][plane]
        planes.append(rgb[:, PLANE_RGB[plane], r::2, c::2])
    return torch.stack(planes, dim=1)
