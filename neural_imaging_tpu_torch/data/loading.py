"""
Image discovery, loading and patch sampling: copy of
``neural_imaging_tpu/data/loading.py`` reading PNG through ``png.read_png``.

RAW inputs are (h/2, w/2, 4) uint16 RGGB stacks in ``*.npy`` files, RGB
targets ``*.png``; patch coordinates are even, so that the half-size RAW
patch stays Bayer-aligned, and the discard policies (flat, flat-aggressive,
dark-n-textured) draw from the caller's numpy generator in the reference's
order, so both packages sample the same patches from the same seed.
"""
import os

import numpy as np

from neural_imaging_tpu_torch.data.png import read_png
from neural_imaging_tpu_torch.utils import fsutil
from neural_imaging_tpu_torch.utils.utils import logger


def discover_images(data_directory, n_images=120, v_images=30, extension='png', randomize=0):
    """Find images and split them into (training, validation) file lists,
    shuffled by ``np.random.default_rng(randomize)`` unless ``randomize`` is 0.
    ``n_images``/``v_images`` of -1 (with the other 0) mean all files."""
    files = fsutil.listdir(data_directory, f'.*\\.{extension}$')
    logger.debug('%s: in total %d files available', data_directory, len(files))

    if randomize:
        rng = np.random.default_rng(randomize)
        rng.shuffle(files)

    if n_images == 0 and v_images == -1:
        v_images = len(files)
    if n_images == -1 and v_images == 0:
        n_images = len(files)

    if len(files) < n_images + v_images:
        raise ValueError('Not enough images!')

    val_files = files[n_images:n_images + v_images]
    files = files[:n_images]
    return files, val_files


def _read_rgb(filename):
    rgb = read_png(filename)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    return rgb[..., :3]


def load_images(files, data_directory, extension='png', load='xy'):
    """Load full-resolution (raw, rgb) pairs into uint16/uint8 arrays."""
    n_images = len(files)
    if n_images == 0:
        logger.warning('No images to load!')
        return {k: np.zeros((1, 1, 1, 1)) for k in load}

    probe = read_png(os.path.join(data_directory, files[0]))
    half = (probe.shape[0] >> 1, probe.shape[1] >> 1)

    data = {}
    if 'x' in load:
        data['x'] = np.zeros((n_images, *half, 4), dtype=np.uint16)
    if 'y' in load:
        data['y'] = np.zeros((n_images, 2 * half[0], 2 * half[1], 3), dtype=np.uint8)

    for i, file in enumerate(files):
        if 'x' in data:
            data['x'][i] = np.load(os.path.join(data_directory, file.replace(f'.{extension}', '.npy')))
        if 'y' in data:
            data['y'][i] = _read_rgb(os.path.join(data_directory, file))
    return data


def load_patches(files, data_directory, patch_size=128, n_patches=100,
                 discard='flat-aggressive', extension='png', load='xy', rng=None):
    """Sample aligned (raw, rgb) patch pairs from full-resolution images.
    ``patch_size`` is in RAW (half-res) coordinates; RGB patches are twice as big."""
    rng = rng or np.random.default_rng()
    v_images = len(files)
    max_attempts = 100
    data = {}
    if 'x' in load:
        data['x'] = np.zeros((v_images * n_patches, patch_size, patch_size, 4), dtype=np.uint16)
    if 'y' in load:
        data['y'] = np.zeros((v_images * n_patches, 2 * patch_size, 2 * patch_size, 3), dtype=np.uint8)

    for i, file in enumerate(files):
        image_x = image_y = None
        if 'x' in data:
            image_x = np.load(os.path.join(data_directory, file.replace(f'.{extension}', '.npy')))
        if 'y' in data:
            image_y = _read_rgb(os.path.join(data_directory, file))

        for b in range(n_patches):
            xx, yy = sample_patch(image_y, 2 * patch_size, discard, max_attempts, rng=rng)
            rx, ry = xx // 2, yy // 2
            if 'x' in data:
                data['x'][i * n_patches + b] = image_x[ry:ry + patch_size, rx:rx + patch_size, :]
            if 'y' in data:
                data['y'][i * n_patches + b] = image_y[yy:yy + 2 * patch_size, xx:xx + 2 * patch_size, :]
    return data


def sample_patch(rgb_image, rgb_patch_size=128, discard=None, max_attempts=25, rng=None):
    """
    Sample (x, y) coordinates of a single patch; coordinates are forced even so that
    the corresponding half-res RAW patch stays Bayer-aligned. Discard policies:

    - ``flat``: soft-reject patches with variance < 0.01
    - ``flat-aggressive``: reject variance < 0.02, falling back to the best seen
    - ``dark-n-textured``: prefer bright, mildly-textured patches
    """
    rng = rng or np.random.default_rng()
    xx, yy = 0, 0
    max_x = rgb_image.shape[1] - rgb_patch_size
    max_y = rgb_image.shape[0] - rgb_patch_size

    if max_x <= 0 and max_y <= 0:
        return xx, yy

    panic_counter = max_attempts
    best_patch = None

    while True:
        xx = 2 * (rng.integers(0, max_x) // 2) if max_x > 0 else 0
        yy = 2 * (rng.integers(0, max_y) // 2) if max_y > 0 else 0

        if not discard:
            return xx, yy

        patch = rgb_image[yy:yy + rgb_patch_size, xx:xx + rgb_patch_size]
        patch = patch.astype(np.float64) / 255 if patch.dtype == np.uint8 else patch.astype(np.float64)
        variance = float(np.var(patch))
        intensity = float(np.mean(patch))

        if discard == 'flat':
            if variance >= 0.01:
                return xx, yy
            if variance >= 0.005 and rng.uniform() > 0.5:
                return xx, yy
            panic_counter -= 1
            if panic_counter <= 0:
                return xx, yy

        elif discard == 'flat-aggressive':
            if variance >= 0.02:
                return xx, yy
            if best_patch is None or variance > best_patch[-1]:
                best_patch = (xx, yy, variance)
            panic_counter -= 1
            if panic_counter <= 0:
                return best_patch[0], best_patch[1]

        elif discard == 'dark-n-textured':
            if 0 < variance < 0.005 and 0.35 < intensity < 0.99:
                return xx, yy
            if best_patch is None or (variance < 2 * best_patch[-1] and intensity > 1.1 * best_patch[-2]):
                best_patch = (xx, yy, intensity, variance)
            panic_counter -= 1
            if panic_counter <= 0:
                return best_patch[0], best_patch[1]

        else:
            raise ValueError(f'Unrecognized discard mode: {discard}')
