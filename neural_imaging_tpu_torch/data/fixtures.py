"""
Procedural training data and simulated camera captures: a port of
``neural_imaging_tpu/data/fixtures.py``. A dataset is a directory in the
reference's format (``*.npy`` uint16 RGGB stacks beside ``*.png`` uint8 RGB
targets), so training needs no download; a capture is a DNG or vendor RAW
file (CR2, NEF, ARW) written by the port's own writers. The arrays and files
are the JAX package's bit for bit (the PNG files are written by
``png.write_png``); the Menon-developed targets of ``make_quality_dataset``
agree with the reference's within a last-bit ±1 of a uint8 value.

Where the reference takes a real photograph (``real_photo``: matplotlib's
sample through imageio, which the GPU machine lacks), the port takes the
caller's ``image_rgb`` / ``photo`` and otherwise a ``procedural_image``, as
the reference does where that photograph is missing.
"""
import os

import numpy as np
from scipy.ndimage import gaussian_filter

from neural_imaging_tpu_torch.data import bayer, camera_raw, dng, png, raw
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


# -----------------------------------------------------------------------------------
# Simulated camera captures
# -----------------------------------------------------------------------------------

def simulate_sensor_mosaic(image_rgb, cfa_pattern, cam_mul, cam2srgb, black, white):
    """sRGB scene → linear → camera space → inverse WB → CFA mosaic → levels."""
    linear = np.power(np.clip(image_rgb, 0, 1), 2.2)
    cam_linear = np.clip(np.einsum('ij,hwj->hwi', np.linalg.inv(cam2srgb), linear), 0, 1)

    # sensor records the scene BEFORE white balance: divide by the multipliers
    cam_mul = np.asarray(cam_mul, dtype=np.float64)
    gains = cam_mul / cam_mul[1]
    sensor = cam_linear / np.array([gains[0], 1.0, gains[2]])[None, None, :]

    mosaic = bayer.mosaic_flat(np.clip(sensor, 0, 1), cfa_pattern)
    return np.clip(black + mosaic * (white - black), 0, 65535).round().astype(np.uint16)


def _capture_inputs(image_rgb, cam2srgb, seed):
    if isinstance(cam2srgb, str) and cam2srgb == 'example':
        cam2srgb = EXAMPLE_SRGB
    if image_rgb is None:
        image_rgb = procedural_image(512, 512, seed)
    return image_rgb, cam2srgb


def make_dng_capture(filename, image_rgb=None, cfa_pattern='RGGB', seed=0,
                     cam_mul=(2.0, 1.0, 1.5, 1.0), cam2srgb='example',
                     black=512, white=16383, camera='SimCam-DNG',
                     compression='none'):
    """
    Simulate a 14-bit camera capture of ``image_rgb`` (sRGB in [0, 1]; a
    512x512 procedural scene where None) and write it as a DNG (``compression``
    'none' or 'ljpeg') with ColorMatrix1/AsShotNeutral metadata: sRGB scene →
    linear → camera color space → inverse white balance → CFA mosaic → black
    level/quantization. Returns the filename.
    """
    image_rgb, cam2srgb = _capture_inputs(image_rgb, cam2srgb, seed)
    mosaic_u16 = simulate_sensor_mosaic(image_rgb, cfa_pattern, cam_mul, cam2srgb,
                                        black, white)
    return dng.write_dng(filename, mosaic_u16, cfa_pattern=cfa_pattern, black=black,
                         white=white, cam_mul=tuple(cam_mul), cam2srgb=cam2srgb,
                         camera=camera, compression=compression)


def make_camera_capture(filename, fmt=None, image_rgb=None, cfa_pattern='RGGB',
                        seed=0, cam_mul=(2.0, 1.0, 1.5, 1.0), cam2srgb='example',
                        black=512, white=16383):
    """The capture of :func:`make_dng_capture` in a vendor container (``fmt``
    in {'cr2', 'nef', 'arw'}; default from the file extension). CR2 carries the
    as-shot WB in its MakerNote ColorData block; NEF/ARW containers have no
    standard WB/color tags, so those are written with the sensor mosaic only.
    Returns the filename."""
    if fmt is None:
        fmt = os.path.splitext(filename)[1].lstrip('.').lower()
    image_rgb, cam2srgb = _capture_inputs(image_rgb, cam2srgb, seed)
    mosaic_u16 = simulate_sensor_mosaic(image_rgb, cfa_pattern, cam_mul, cam2srgb,
                                        black, white)
    if fmt == 'cr2':
        return camera_raw.write_cr2(filename, mosaic_u16, cfa_pattern=cfa_pattern,
                                    precision=14, cam_mul=cam_mul, black=black,
                                    white=white, camera='SimCam-CR2')
    if fmt == 'nef':
        return camera_raw.write_nef(filename, mosaic_u16, cfa_pattern=cfa_pattern,
                                    bits=14, black=black, white=white,
                                    camera='SimCam-NEF')
    if fmt == 'arw':
        return camera_raw.write_arw(filename, mosaic_u16, cfa_pattern=cfa_pattern,
                                    bits=16, black=black, white=white,
                                    camera='SimCam-ARW')
    raise ValueError(f'Unsupported camera container: {fmt!r}')


def make_quality_dataset(directory, n_images=60, height=256, width=384, seed=900,
                         cfa_pattern='GBRG', noise=None, photo=None, device='cuda'):
    """
    A reference-scale training set (default 60 images, the 40:20:1 split's
    total) in the reference's directory format, its targets developed with
    Menon on ``device``. Even images are random crops/flips/exposure variants
    of ``photo`` (sRGB in [0, 1]) where one is given; the others, and all
    without a photo, procedural scenes.

    ``noise``: optional ``(shot, read)`` sensor-noise model applied to the RAW
    mosaic ONLY — std = sqrt(shot²·signal + read²) in normalized units (e.g.
    ``(0.02, 0.01)`` ≈ a high-ISO capture) — while the .png target is developed
    from the CLEAN mosaic, so ISPs train on a joint denoise+demosaic task.
    """
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)

    for i in range(n_images):
        if photo is not None and i % 2 == 0:
            h, w = photo.shape[:2]
            ch, cw = min(height, h), min(width, w)
            y0 = int(rng.integers(0, h - ch + 1)) // 2 * 2
            x0 = int(rng.integers(0, w - cw + 1)) // 2 * 2
            crop = photo[y0:y0 + ch, x0:x0 + cw]
            if rng.uniform() < 0.5:
                crop = crop[:, ::-1]
            if rng.uniform() < 0.5:
                crop = crop[::-1, :]
            crop = np.clip(crop * rng.uniform(0.7, 1.15), 0, 1)
            scene = np.ascontiguousarray(crop)
        else:
            scene = procedural_image(height, width, seed + i)

        cam_linear = np.clip(np.einsum('ij,hwj->hwi', np.linalg.inv(EXAMPLE_SRGB),
                                       np.power(scene, 2.2)), 0, 1)
        mosaic = bayer.mosaic_flat(cam_linear, cfa_pattern)
        mosaic_captured = mosaic
        if noise is not None:
            shot, read = noise
            sigma = np.sqrt(shot * shot * mosaic + read * read)
            mosaic_captured = np.clip(
                mosaic + sigma * rng.standard_normal(mosaic.shape), 0, 1)
        stack = bayer.stack_bayer(
            np.stack([mosaic_captured * m
                      for m in raw._cfa_masks(mosaic.shape, cfa_pattern)],
                     axis=-1), cfa_pattern)
        stack_u16 = np.clip(stack * 65535, 0, 65535).round().astype(np.uint16)
        developed = raw.develop(mosaic, cfa_pattern, cam2srgb=EXAMPLE_SRGB,
                                brightness=None, use_gamma=True, demosaicing='menon',
                                device=device)
        name = f'quality_{i:04d}'
        png.write_png(os.path.join(directory, name + '.png'),
                      raw.to_uint8(developed))
        np.save(os.path.join(directory, name + '.npy'), stack_u16)
    return directory


def make_dng_dataset(directory, n_images=4, cfa_pattern='RGGB', seed=400, photo=None):
    """A directory of DNG captures: 384x384 crops of ``photo`` (every odd
    one mirrored) where one is given, procedural scenes otherwise. Returns
    the file names."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n_images):
        if photo is not None:
            h, w = photo.shape[:2]
            ch, cw = min(384, h), min(384, w)
            y0 = int(rng.integers(0, h - ch + 1)) // 2 * 2
            x0 = int(rng.integers(0, w - cw + 1)) // 2 * 2
            crop = photo[y0:y0 + ch, x0:x0 + cw]
            if i % 2 == 1:
                crop = crop[:, ::-1]  # mirrored variant
        else:
            crop = procedural_image(384, 384, seed + i)
        path = os.path.join(directory, f'capture_{i:04d}.dng')
        make_dng_capture(path, image_rgb=np.ascontiguousarray(crop),
                         cfa_pattern=cfa_pattern, seed=seed + i)
        files.append(path)
    return files
