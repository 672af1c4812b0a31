"""
The reference INet: fixed Bayer scatter, TF-order depth_to_space, reflect
pad, demosaic conv, sRGB 1x1, two-layer tanh gamma, straight-through clip.
Its weights are the leaves of a JAX-format snapshot (HWIO kernels), read
here with numpy, or drawn from the seed at the shapes ``leaf_shapes`` gives.
"""
import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ops
from benchmark.reference.isp import CFA_OFFSETS, PLANE_RGB, PLANES

LEAVES = ('demosaic', 'srgb', 'gamma_d1_kernel', 'gamma_d1_bias', 'gamma_d2_kernel',
          'gamma_d2_bias')


def scatter_kernel(cfa):
    """(12, 4, 1, 1): the stack's planes into depth_to_space(2) order."""
    k = np.zeros((12, 4, 1, 1), np.float32)
    for i, plane in enumerate(PLANES):
        r, c = CFA_OFFSETS[cfa][plane]
        k[(r * 2 + c) * 3 + PLANE_RGB[plane], i] = 1
    return k


def load(npz_path, device):
    """INet's leaves {name: tensor} from a snapshot: kernels OIHW, biases as they are."""
    with np.load(npz_path) as z:
        return {k: (ops.hwio(z[k], device) if z[k].ndim == 4
                    else torch.as_tensor(z[k], dtype=torch.float32, device=device))
                for k in LEAVES}


def leaf_shapes(kernel=5, **_):
    """{name: shape} of INet's leaves, OIHW."""
    return {'demosaic': (3, 3, kernel, kernel), 'srgb': (3, 3, 1, 1),
            'gamma_d1_kernel': (12, 3, 1, 1), 'gamma_d1_bias': (12,),
            'gamma_d2_kernel': (3, 12, 1, 1), 'gamma_d2_bias': (3,)}


def develop(x, leaves, cfa_pattern='gbrg', kernel=5, **_):
    """(N, 4, h, w) Bayer stack → (N, 3, 2h, 2w) RGB in [0, 1]."""
    up = torch.as_tensor(scatter_kernel(cfa_pattern), device=x.device)
    bayer = ops.depth_to_space(F.conv2d(x, up), 2)
    p = (kernel - 1) // 2
    rgb = F.conv2d(F.pad(bayer, (p, p, p, p), mode='reflect'), leaves['demosaic'])
    srgb = F.conv2d(rgb, leaves['srgb'])
    g = torch.tanh(F.conv2d(srgb, leaves['gamma_d1_kernel'], leaves['gamma_d1_bias']))
    return ops.st_clip(F.conv2d(g, leaves['gamma_d2_kernel'], leaves['gamma_d2_bias']))
