"""
Rate-distortion benchmarking: per-image R/D tables for JPEG, JPEG 2000, BPG,
WebP, AVIF and the learned DCN codecs, CSV caches next to the data, and the
parametric curve fits. Port of ``neural_imaging_tpu/compression/ratedistortion.py``.

The columns (image_id, filename, codec, quality, ssim, psnr, msssim_db,
bytes, bpp) and the fit families (logistic in log-bpp for SSIM, log-quadratic
for PSNR and MS-SSIM dB) are the reference's. A :class:`Table`
(``utils/table.py``) stands in for its pandas DataFrame and writes and reads
the same CSV: each package reads the other's cache. Every leg's codec runs on
the host and MS-SSIM on the caller's device:
- JPEG: libjpeg's codec, the port's own (``compression/baseline_jpeg.py``);
- JPEG 2000: the system's libopenjp2 (``compression/jp2_helpers.py``), as
  OpenCV drives it in the reference; without it the leg raises, where the
  reference fails to import OpenCV;
- BPG: the bpgenc/bpgdec binaries (``compression/bpg_helpers.py``);
- WebP and AVIF: the system's libwebp and libavif (``compression/webp.py``,
  ``compression/avif.py``), in place of Pillow's;
- DCN: each codec restored on the device, compressed through K2
  (``codec.simulate_compression``).
BPG, WebP and AVIF give an empty table with a warning when their binaries or
library are absent, as in the reference; :func:`codec_libraries` says which
load. The sweep reads PNG, BMP and binary PPM images. The plots need
matplotlib and stay in the JAX package.
"""
import math
import os
from pathlib import Path

import numpy as np
import torch
from scipy.optimize import curve_fit

from neural_imaging_tpu_torch.compression import avif, bpg_helpers, codec as codec_mod, hevc
from neural_imaging_tpu_torch.compression import jp2_helpers, jpeg_helpers, webp
from neural_imaging_tpu_torch.data.bmp import read_bmp
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
    return read_bmp(path)


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


def _library_error(module):
    """None when ``module``'s library loads, else the reason it does not."""
    try:
        module.library()
        return None
    except RuntimeError as e:
        return str(e)


def codec_libraries():
    """{name: (True, version) or (False, the reason it does not load)} of
    the libraries and binaries the host codecs of the sweep need."""
    found = {}
    for name, module in (('libopenjp2', jp2_helpers), ('libwebp', webp), ('libavif', avif)):
        error = _library_error(module)
        found[name] = (False, error) if error else (True, module.version())
    try:
        found.update({f'lib{k}': (True, v) for k, v in hevc.versions().items()})
    except hevc.HEVCError as e:
        for name, handle in (('libx265', hevc._X265), ('libde265', hevc._De265)):
            try:
                handle()
                found[name] = (True, f'loads, but the codec does not: {e}')
            except hevc.HEVCError as own:
                found[name] = (False, str(own))
    found['bpgenc/bpgdec'] = ((True, f'{bpg_helpers.BPGENC}, {bpg_helpers.BPGDEC}')
                              if bpg_helpers.bpg_available()
                              else (False, 'bpgenc/bpgdec binaries not on PATH'))
    return found


def _u8(img):
    return (img * 255).round().astype(np.uint8)


def get_jpeg2k_df(directory, write_files=False, effective_bytes=True, force_calc=False,
                  files=None, qualities=tuple(range(25, 46)), device='cuda'):
    """JPEG 2000 R/D sweep through OpenJPEG: PSNR-targeted encoding (25-45 dB)
    with the effective payload bytes of the codestream's tile-parts; MS-SSIM
    on ``device``. Raises OpenJPEGError, naming libopenjp2, when it does not
    load and the cache does not cover the sweep."""
    device = resolve_device(device)

    def build():
        names, images = _load_images(directory, files)
        rows = []
        for i, (name, img) in enumerate(zip(names, images)):
            u8 = _u8(img)
            for q in qualities:
                buf, decoded = jp2_helpers.encode_jp2(u8, psnr_target=float(q))
                nbytes = jp2_helpers.jp2_payload_bytes(buf) if effective_bytes else len(buf)
                rows.append(_row(i, name, 'jpeg2000', q, img, decoded, nbytes, device))
                _maybe_write(directory, 'jpeg2000', name, q, decoded, write_files)
        return Table(rows)
    return _cached(build, directory, 'jpeg2000.csv', force_calc, qualities=qualities,
                   files=files)


def get_bpg_df(directory, write_files=False, force_calc=False, files=None,
               qualities=range(15, 48, 3), device='cuda'):
    """BPG R/D sweep (needs bpgenc/bpgdec; an empty table otherwise); MS-SSIM
    on ``device``."""
    if not bpg_helpers.bpg_available():
        logger.warning('bpgenc/bpgdec unavailable — skipping the BPG sweep')
        return Table()
    device = resolve_device(device)

    def build():
        names, images = _load_images(directory, files)
        rows = []
        for i, (name, img) in enumerate(zip(names, images)):
            for q in qualities:
                decoded, bpp = bpg_helpers.roundtrip(img, q)
                nbytes = int(bpp * img.shape[0] * img.shape[1] / 8)
                rows.append(_row(i, name, 'bpg', q, img, decoded, nbytes, device))
                _maybe_write(directory, 'bpg', name, q, decoded, write_files)
        return Table(rows)
    return _cached(build, directory, 'bpg.csv', force_calc, qualities=qualities, files=files)


def _host_leg(directory, codec, module, write_files, force_calc, files, qualities, device,
              **encode_kw):
    """The WebP or AVIF sweep: ``module.encode`` / ``decode`` at each quality
    (an empty table with a warning when its library does not load)."""
    error = _library_error(module)
    if error:
        logger.warning('%s — skipping the %s sweep', error, codec)
        return Table()
    device = resolve_device(device)

    def build():
        names, images = _load_images(directory, files)
        rows = []
        for i, (name, img) in enumerate(zip(names, images)):
            u8 = _u8(img)
            for q in qualities:
                buf = module.encode(u8, int(q), **encode_kw)
                decoded = module.decode(buf).astype(np.float32) / 255.0
                rows.append(_row(i, name, codec, q, img, decoded, len(buf), device))
                _maybe_write(directory, codec, name, q, decoded, write_files)
        return Table(rows)
    return _cached(build, directory, f'{codec}.csv', force_calc, qualities=qualities,
                   files=files)


def get_webp_df(directory, write_files=False, force_calc=False, files=None,
                qualities=range(10, 96, 5), device='cuda'):
    """WebP (VP8 intra) R/D sweep through libwebp at method 4; MS-SSIM on
    ``device``. An empty table when libwebp does not load."""
    return _host_leg(directory, 'webp', webp, write_files, force_calc, files, qualities, device)


def get_avif_df(directory, write_files=False, force_calc=False, files=None,
                qualities=range(10, 96, 5), device='cuda'):
    """AVIF (AV1 intra) R/D sweep through libavif at speed 6; MS-SSIM on
    ``device``. An empty table when libavif does not load."""
    return _host_leg(directory, 'avif', avif, write_files, force_calc, files, qualities, device,
                     speed=6)


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
