"""
Procedural training data: copy of ``procedural_image``, ``make_raw_rgb_pair``
and ``make_dataset`` of ``neural_imaging_tpu/data/fixtures.py``. A dataset is
a directory in the reference's format (``*.npy`` uint16 RGGB stacks beside
``*.png`` uint8 RGB targets), so training needs no download. The arrays are
the JAX package's bit for bit; the PNG files are written by ``png.write_png``.
"""
import os

import numpy as np
from scipy.ndimage import gaussian_filter

from neural_imaging_tpu_torch.data import bayer, png, raw
from neural_imaging_tpu_torch.ops.kernels import EXAMPLE_SRGB


def procedural_image(height, width, seed=0):
    """
    A procedurally textured RGB image in [0,1]: smooth color field + multi-scale
    texture + random geometric edges (flat, textured and high-contrast content
    in each image).
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    yy /= height
    xx /= width

    img = np.zeros((height, width, 3))
    # Smooth color gradient base
    for c in range(3):
        a, b, cph = rng.uniform(-1, 1, 3)
        img[..., c] = 0.5 + 0.25 * (a * xx + b * yy) + 0.15 * np.sin(2 * np.pi * (xx * rng.uniform(0.5, 2) + cph))

    # Multi-scale filtered noise texture (shared across channels with color tint)
    tex = np.zeros((height, width))
    for sigma, amp in ((1, 0.08), (4, 0.12), (16, 0.15)):
        noise = rng.standard_normal((height, width))
        tex += amp * gaussian_filter(noise, sigma) * (sigma ** 0.5)
    tint = rng.uniform(0.5, 1.0, 3)
    img += tex[..., None] * tint[None, None, :]

    # Random rectangles and discs with hard edges
    for _ in range(8):
        color = rng.uniform(0, 1, 3)
        if rng.uniform() < 0.5:
            y0, x0 = rng.integers(0, height - 8), rng.integers(0, width - 8)
            h = int(rng.integers(height // 16, height // 3))
            w = int(rng.integers(width // 16, width // 3))
            img[y0:y0 + h, x0:x0 + w] = 0.6 * img[y0:y0 + h, x0:x0 + w] + 0.4 * color
        else:
            cy, cx = rng.integers(0, height), rng.integers(0, width)
            r = int(rng.integers(min(height, width) // 16, min(height, width) // 4))
            mask = (yy * height - cy) ** 2 + (xx * width - cx) ** 2 < r ** 2
            img[mask] = 0.6 * img[mask] + 0.4 * color

    return np.clip(img, 0, 1)


def make_raw_rgb_pair(height, width, seed=0, cfa_pattern='GBRG', cam2srgb='example'):
    """
    Simulate a camera capture: scene RGB → camera color space → linear → Bayer
    mosaic → (uint16 RGGB stack, uint8 developed RGB). The target is developed
    from the mosaic (bilinear demosaic → cam2sRGB → gamma), so RAW → RGB is a
    consistent, learnable mapping. ``'example'`` is the EXAMPLE_SRGB profile,
    the one INet's color stage starts from.
    """
    if isinstance(cam2srgb, str) and cam2srgb == 'example':
        cam2srgb = EXAMPLE_SRGB

    scene = procedural_image(height, width, seed)
    if cam2srgb is not None:
        # scene is defined in sRGB; sample the sensor in camera RGB space
        cam_linear = np.einsum('ij,hwj->hwi', np.linalg.inv(cam2srgb),
                               np.power(scene, 2.2))
        cam_linear = np.clip(cam_linear, 0, 1)
    else:
        cam_linear = np.power(scene, 2.2)
    mosaic = bayer.mosaic_flat(cam_linear, cfa_pattern)
    stack = bayer.stack_bayer(
        np.stack([mosaic * m for m in raw._cfa_masks(mosaic.shape, cfa_pattern)], axis=-1),
        cfa_pattern)
    stack_u16 = np.clip(stack * (2 ** 16 - 1), 0, 2 ** 16 - 1).round().astype(np.uint16)

    developed = raw.develop_mosaic(mosaic, cfa_pattern, cam2srgb=cam2srgb,
                                   brightness=None, use_gamma=True,
                                   demosaicing='bilinear')
    rgb_u8 = np.clip(developed * 255, 0, 255).round().astype(np.uint8)
    return stack_u16, rgb_u8


def make_dataset(directory, n_images=8, height=256, width=384, seed=1000,
                 cfa_pattern='GBRG', rgb_only=False):
    """Write a reference-format training directory of synthetic pairs."""
    os.makedirs(directory, exist_ok=True)
    for i in range(n_images):
        stack_u16, rgb_u8 = make_raw_rgb_pair(height, width, seed=seed + i, cfa_pattern=cfa_pattern)
        name = f'synthetic_{i:04d}'
        png.write_png(os.path.join(directory, name + '.png'), rgb_u8)
        if not rgb_only:
            np.save(os.path.join(directory, name + '.npy'), stack_u16)
    return directory
