"""
Rate-distortion benchmarking: per-image R/D tables for JPEG and the learned
DCN codecs, CSV caches next to the data, and the parametric curve fits. Port
of ``neural_imaging_tpu/compression/ratedistortion.py``.

The columns (image_id, filename, codec, quality, ssim, psnr, msssim_db,
bytes, bpp) and the fit families (logistic in log-bpp for SSIM, log-quadratic
for PSNR and MS-SSIM dB) are the reference's. A :class:`Table`
(``utils/table.py``) stands in for its pandas DataFrame and writes and reads
the same CSV: each package reads the other's cache. The JPEG leg runs libjpeg's codec (the port's own,
``compression/baseline_jpeg.py``) on the host; the DCN leg restores each
codec on the caller's device and compresses through K2
(``codec.simulate_compression``); MS-SSIM runs on that device too. The
JPEG 2000, BPG, WebP and AVIF legs need OpenCV/OpenJPEG, bpgenc, libwebp or
libavif and raise ``NotImplementedError``; the plots need matplotlib and are
not ported (ROADMAP.md §1 item 3).
"""
import math
import os
from pathlib import Path

import numpy as np
import torch
from scipy.optimize import curve_fit

from neural_imaging_tpu_torch.compression import codec as codec_mod, jpeg_helpers
from neural_imaging_tpu_torch.data.png import read_png, write_png
from neural_imaging_tpu_torch.ops import ssim as ssim_ops
from neural_imaging_tpu_torch.utils import metrics, table
from neural_imaging_tpu_torch.utils.device import resolve_device
from neural_imaging_tpu_torch.utils.utils import logger

RD_COLUMNS = ['image_id', 'filename', 'codec', 'quality', 'ssim', 'psnr',
              'msssim_db', 'bytes', 'bpp']


class Table(table.Table):
    """The shared table (``utils/table.py``) with the R/D columns by default."""

    def __init__(self, rows=(), columns=RD_COLUMNS):
        super().__init__(rows, columns)


def _sweep_files(directory, files=None):
    return files or sorted(f for f in os.listdir(directory)
                           if f.lower().endswith(('.png', '.bmp', '.ppm')))


def _read_ppm(path):
    """A binary (P6) 8-bit PPM as an (h, w, 3) uint8 array."""
    with open(path, 'rb') as f:
        blob = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while blob[pos:pos + 1].isspace():
            pos += 1
        if blob[pos:pos + 1] == b'#':
            pos = blob.index(b'\n', pos) + 1
            continue
        end = pos
        while not blob[end:end + 1].isspace():
            end += 1
        fields.append(blob[pos:end])
        pos = end
    magic, width, height, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b'P6' or maxval != 255:
        raise NotImplementedError(f'{path}: only binary 8-bit PPM (P6, maxval 255) is read')
    pixels = np.frombuffer(blob, np.uint8, count=width * height * 3, offset=pos + 1)
    return pixels.reshape(height, width, 3)


def _read_image(path):
    suffix = path.lower().rsplit('.', 1)[-1]
    if suffix == 'png':
        return read_png(path)
    if suffix == 'ppm':
        return _read_ppm(path)
    raise NotImplementedError(f'{path}: BMP images are not read by the port (ROADMAP.md §1 '
                              'item 3); convert them to PNG')


def _load_images(directory, files=None):
    files = _sweep_files(directory, files)
    images = []
    for f in files:
        img = _read_image(os.path.join(directory, f))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        images.append(img[..., :3].astype(np.float32) / 255.0)
    return files, images


def _msssim_db(a, b, device):
    """MS-SSIM in dB, -10 log10(1 - msssim), computed on ``device``."""
    a, b = (torch.as_tensor(x[None], device=device) for x in (a, b))
    v = float(ssim_ops.ms_ssim(a, b)[0])
    return -10.0 * np.log10(max(1.0 - v, 1e-9))


def _row(image_id, filename, codec, quality, original, decoded, nbytes, device):
    h, w = original.shape[:2]
    return {
        'image_id': image_id, 'filename': filename, 'codec': codec, 'quality': quality,
        'ssim': metrics.ssim(original, decoded),
        'psnr': metrics.psnr(original, decoded),
        'msssim_db': _msssim_db(original, decoded, device),
        'bytes': nbytes, 'bpp': 8.0 * nbytes / (h * w),
    }


def _maybe_write(directory, codec, filename, quality, decoded, write):
    """Optionally keep a decoded image as ``<directory>/<codec>/<stem>_q<quality>.png``."""
    if not write:
        return
    out_dir = os.path.join(directory, codec)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(filename))[0]
    u8 = (np.clip(decoded, 0.0, 1.0) * 255).round().astype(np.uint8)
    write_png(os.path.join(out_dir, f'{stem}_q{quality}.png'), u8)


def _cached(table_fn, directory, cache_name, force=False, qualities=None, files=None):
    """CSV-cache a sweep, reused only when it covers the same sweep: the same
    quality set and the same file set (else a stale cache would be returned)."""
    cache = os.path.join(directory, cache_name)
    if os.path.isfile(cache) and not force:
        table = Table.read_csv(cache)
        stale = []
        if qualities is not None and not table.empty:
            want = {float(q) for q in qualities}
            have = {float(q) for q in table.unique('quality')}
            if want != have:
                stale.append(f'qualities {sorted(have)} != requested {sorted(want)}')
        if not table.empty:
            if set(_sweep_files(directory, files)) != set(table.unique('filename')):
                stale.append('file set changed')
        if not stale:
            logger.info('R/D cache hit: %s', cache)
            return table
        logger.info('R/D cache %s is stale (%s) — rebuilding', cache, '; '.join(stale))
    table = table_fn()
    table.to_csv(cache)
    return table


def get_jpeg_df(directory, write_files=False, effective_bytes=True, force_calc=False,
                files=None, qualities=range(10, 96, 5), device='cuda'):
    """JPEG R/D sweep over a directory of images (libjpeg's codec, 4:4:4);
    MS-SSIM on ``device``."""
    device = resolve_device(device)

    def build():
        names, images = _load_images(directory, files)
        rows = []
        for i, (name, img) in enumerate(zip(names, images)):
            for q in qualities:
                decoded, nbytes = jpeg_helpers.compress_batch(img, q, effective=effective_bytes)
                rows.append(_row(i, name, 'jpeg', q, img, decoded, nbytes, device))
                _maybe_write(directory, 'jpeg', name, q, decoded, write_files)
        return Table(rows)
    return _cached(build, directory, 'jpeg.csv', force_calc, qualities=qualities, files=files)


def _not_ported(leg, needs):
    raise NotImplementedError(f'the {leg} R/D leg needs {needs}, which the port does not have '
                              '(ROADMAP.md §1 item 3); the JAX package runs it')


def get_jpeg2k_df(*args, **kwargs):
    _not_ported('JPEG 2000', 'OpenCV with OpenJPEG')


def get_bpg_df(*args, **kwargs):
    _not_ported('BPG', 'the bpgenc/bpgdec binaries')


def get_webp_df(*args, **kwargs):
    _not_ported('WebP', "Pillow's libwebp")


def get_avif_df(*args, **kwargs):
    _not_ported('AVIF', "Pillow's libavif")


def get_dcn_df(directory, model_directory, write_files=False, force_calc=False, files=None,
               device='cuda'):
    """Learned-codec R/D: every trained DCN (``**/progress.json``) under
    ``model_directory``, restored on ``device``, runs the real bitstream
    round trip on each image (cropped to a multiple of 8)."""
    device = resolve_device(device)

    def build():
        names, images = _load_images(directory, files)
        model_dirs = sorted({str(p.parent) for p in Path(model_directory).glob('**/progress.json')})
        rows = []
        for mdir in model_dirs:
            try:
                dcn = codec_mod.restore(mdir, patch_size=None, device=device)
            except Exception as e:
                logger.warning('could not restore %s: %s', mdir, e)
                continue
            code = dcn.model_code
            for i, (name, img) in enumerate(zip(names, images)):
                h, w = (img.shape[0] // 8) * 8, (img.shape[1] // 8) * 8
                crop = img[:h, :w]
                decoded, nbytes = codec_mod.simulate_compression(crop[None], dcn)
                rows.append(_row(i, name, code, math.nan, crop, decoded[0], nbytes, device))
                _maybe_write(directory, code, name, 'dcn', decoded[0], write_files)
        return Table(rows)
    return _cached(build, directory, 'dcn.csv', force_calc, files=files)


# ------------------------------------------------------------------------------------
# Curve fitting
# ------------------------------------------------------------------------------------

def fit_logistic(bpp, quality, sigma=None):
    """SSIM-style fit: a logistic curve in log(bpp), lower-quality samples
    down-weighted by sigma = |1 - y|."""
    def fn(x, a, b, c, d):
        return a / (1 + np.exp(-b * (np.log(x) - c))) + d
    popt, _ = curve_fit(fn, bpp, quality, p0=(0.5, 2.0, -1.0, 0.5), maxfev=20000,
                        bounds=([0, 0.1, -5, 0], [1, 20, 5, 1]), sigma=sigma)
    return lambda x: fn(x, *popt)


def fit_log(bpp, quality, sigma=None):
    """PSNR-style fit: a log(bpp) + b + c log(bpp)²."""
    def fn(x, a, b, c):
        lx = np.log(x)
        return a * lx + b + c * lx ** 2
    popt, _ = curve_fit(fn, bpp, quality, p0=(5.0, 30.0, 0.0), maxfev=20000, sigma=sigma)
    return lambda x: fn(x, *popt)


_FITTERS = {'ssim': fit_logistic, 'msssim_db': fit_log, 'psnr': fit_log}


def _fit_sigma(metric, quality):
    if metric == 'ssim':
        return np.maximum(np.abs(1.0 - quality), 1e-3)
    return None


def _grid(bpp, points):
    lo, hi = np.percentile(bpp, 1), np.percentile(bpp, 99)
    return np.geomspace(max(lo, 1e-3), hi, points)


def fit_rd_curve(table, metric='ssim', points=50, grid=None):
    """Fit the pooled R/D samples of one codec; returns (bpp_grid, fitted)."""
    table = table.dropna([metric, 'bpp'])
    bpp, quality = table['bpp'].astype(np.float64), table[metric].astype(np.float64)
    if grid is None:
        grid = _grid(bpp, points)
    fitted = _FITTERS[metric](bpp, quality, sigma=_fit_sigma(metric, quality))(grid)
    return grid, fitted


def fit_rd_curve_per_image(table, metric='ssim', points=50, grid=None):
    """Fit each image's samples on a common bpp grid, then average the
    fitted curves (the reference's 'fit' mode)."""
    table = table.dropna([metric, 'bpp'])
    if grid is None:
        grid = _grid(table['bpp'].astype(np.float64), points)
    curves = []
    for image_id, sel in table.groupby('image_id'):
        if len(sel) < 4:
            continue
        y = sel[metric].astype(np.float64)
        try:
            fit = _FITTERS[metric](sel['bpp'].astype(np.float64), y, sigma=_fit_sigma(metric, y))
            curves.append(fit(grid))
        except (RuntimeError, ValueError):
            logger.warning('per-image R/D fit failed for image_id=%s', image_id)
    if not curves:
        raise ValueError('No image had enough samples for a per-image fit')
    return grid, np.nanmean(np.stack(curves), axis=0)


def aggregate_rd(table, metric='ssim'):
    """Mean bpp and metric per quality level (the reference's 'aggregate' mode)."""
    group_key = 'n_features' if 'n_features' in table else 'quality'
    groups = table.dropna([metric, 'bpp']).groupby(group_key)
    return (np.array([g['bpp'].astype(np.float64).mean() for _, g in groups]),
            np.array([g[metric].astype(np.float64).mean() for _, g in groups]))
