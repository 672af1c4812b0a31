"""
The reference manipulations at fixed strengths, on NCHW RGB in [0, 1]:
sharpen (of H and V in tf.image's HSV), bilinear resampling down and back
up (jax.image.resize's antialiased operator), Gaussian blur, JPEG; any
other manipulation is found by name in ``manipulation_<name>.py``.
"""
import functools

import numpy as np
import torch

from benchmark.reference import by_name
from benchmark.reference import jpeg as jpeg_ref
from benchmark.reference import ops


def rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(1)
    v, mn = rgb.amax(1), rgb.amin(1)
    rng = v - mn
    pos = rng > 0
    safe = torch.where(pos, rng, torch.ones_like(rng))
    h = torch.where(v == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(v == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(pos, h / 6.0, torch.zeros_like(h))
    vpos = v > 0
    s = torch.where(vpos, rng / torch.where(vpos, v, torch.ones_like(v)), torch.zeros_like(v))
    return torch.stack([h, s, v], dim=1)


def hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(1)
    dh = torch.remainder(h, 1.0) * 6.0
    d = [ops.clip(torch.abs(dh - 3.0) - 1.0, 0.0, 1.0),
         ops.clip(-torch.abs(dh - 2.0) + 2.0, 0.0, 1.0),
         ops.clip(-torch.abs(dh - 4.0) + 2.0, 0.0, 1.0)]
    return v[:, None] * torch.stack([(1.0 - s) + s * di for di in d], dim=1)


@functools.lru_cache()
def sharpen_kernel(strength):
    """(3, 3, 3) per-channel filters: unsharp mask on H and V, and on S a
    pass-through tap at (2, 2), as the published manipulation has it."""
    gk = np.array([[-0.0833, -0.1667, -0.0833], [-0.1667, 0.0, -0.1667],
                   [-0.0833, -0.1667, -0.0833]])
    gk = strength * gk / np.abs(gk.sum())
    gk[1, 1] = strength + 1
    k = np.stack([gk, np.zeros((3, 3)), gk], axis=-1)
    k[2, 2, 1] = 1
    return k.astype(np.float32)


def sharpen(x, strength=1.0):
    k = torch.as_tensor(sharpen_kernel(float(strength)), device=x.device)
    return ops.clip(hsv_to_rgb(ops.depthwise(rgb_to_hsv(x), k, 'symmetric')), 0.0, 1.0)


@functools.lru_cache()
def resize_matrix(n_in, n_out):
    """(n_out, n_in) operator of jax.image.resize 'bilinear' along one axis:
    half-pixel centres, triangle kernel widened when shrinking, weights
    normalized per output sample; float32 steps as jax takes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(dist)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


def resize(x, h, w):
    rows = torch.as_tensor(resize_matrix(x.shape[-2], h), device=x.device)
    cols = torch.as_tensor(resize_matrix(x.shape[-1], w), device=x.device)
    return rows @ x @ cols.T


def resample(x, percent=50):
    side = x.shape[-2]
    size = side * int(percent) // 100
    return resize(resize(x, size, size), side, side)


def gaussian(x, std=0.83, kernel=5):
    n = np.arange(kernel) - (kernel - 1.0) / 2.0
    g = np.exp(-n ** 2 / (2 * std * std))
    g2 = np.outer(g, g)
    k = torch.as_tensor(np.repeat((g2 / g2.sum())[:, :, None], x.shape[1], 2).astype(np.float32),
                        device=x.device)
    return ops.clip(ops.depthwise(x, k, 'reflect'), 0.0, 1.0)


def jpeg(x, quality=80):
    return jpeg_ref.jpeg(x, quality)[0]


MANIPULATIONS = {'sharpen': sharpen, 'resample': resample, 'gaussian': gaussian, 'jpeg': jpeg}


def function(name):
    """A manipulation's reference: the table's, else ``apply`` of
    ``manipulation_<name>.py`` (``by_name.manipulation``)."""
    return MANIPULATIONS[name] if name in MANIPULATIONS else by_name.manipulation(name).apply


def expand(y, specs):
    """[y] + each manipulation of ``specs`` ('name:strength'), class-major."""
    out = [y]
    for spec in specs:
        name, strength = spec.split(':')
        out.append(function(name)(y, float(strength)))
    return torch.cat(out, dim=0)
