"""
Host JPEG utilities: IJG quantization tables, the quality scaling law and
quality estimation, libjpeg-exact encoding (``compression/baseline_jpeg.py``,
the port's own codec, in place of PIL), quality matching by SSIM / bpp
bisection, and a marker walker for effective-payload measurement. Port of
``neural_imaging_tpu/compression/jpeg_helpers.py``.
"""
from collections import OrderedDict

import numpy as np

from neural_imaging_tpu_torch.compression import baseline_jpeg
from neural_imaging_tpu_torch.utils import metrics
from neural_imaging_tpu_torch.utils.utils import logger

# Annex K (IJG) base quantization tables, the public JPEG standard's constants
K1_LUMA, K2_CHROMA = (t.reshape(8, 8).astype(np.float32) for t in baseline_jpeg.STD_QUANT)

_SUBSAMPLING = baseline_jpeg.SUBSAMPLING


def jpeg_qtable(quality, channel=0):
    """DCT quantization matrix for an IJG quality level (1-100)."""
    quality = float(np.clip(quality, 1, 100))
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    t = K1_LUMA if channel == 0 else K2_CHROMA
    t = np.floor((t * scale + 50.0) / 100.0)
    return np.clip(t, 1, 255).astype(np.float32)


def jpeg_qf_estimation(q_mtx, channel=0):
    """The quality factor whose IJG table is nearest ``q_mtx`` (mean |diff|)."""
    q_mtx = np.asarray(q_mtx)
    errors = [np.mean(np.abs(jpeg_qtable(qf, channel) - q_mtx)) for qf in range(1, 101)]
    return int(np.argmin(errors)) + 1


def zigzag(n=8):
    """Zigzag scan-order index matrix of size n×n."""
    zz = np.zeros((n, n), dtype=np.uint16)
    order = sorted(((x, y) for x in range(n) for y in range(n)),
                   key=lambda xy: (xy[0] + xy[1], -xy[1] if (xy[0] + xy[1]) % 2 else xy[1]))
    for i, (x, y) in enumerate(order):
        zz[x, y] = i
    return zz


def _encode_one(image_u8, quality, subsampling):
    """(decoded uint8 image, file bytes) of one image, as libjpeg gives them;
    an unknown subsampling is 4:4:4, as in the reference."""
    data = baseline_jpeg.encode(image_u8, int(quality), _SUBSAMPLING.get(subsampling, 0))
    return baseline_jpeg.decode(data), data


def compress_batch(batch_x, jpeg_quality, effective=False, subsampling='4:4:4'):
    """
    Compress images with libjpeg's codec. Accepts float [0,1] (or uint8-scale)
    arrays of shape (h, w, 3) or (n, h, w, 3). Returns (images float [0,1],
    bytes or list of bytes); ``effective`` counts the bytes from the first
    Huffman table on (``JPEGMarkerStats.get_effective_bytes``).
    """
    batch_x = np.asarray(batch_x)
    if batch_x.max() > 1:
        batch_x = batch_x.astype(np.float32) / 255.0

    def run(img):
        u8 = np.clip(255 * img, 0, 255).astype(np.uint8)
        decoded, data = _encode_one(u8, jpeg_quality, subsampling)
        nbytes = JPEGMarkerStats(data).get_effective_bytes() if effective else len(data)
        return decoded.astype(np.float32) / 255.0, nbytes

    if batch_x.ndim == 3:
        return run(batch_x)
    if batch_x.ndim == 4:
        out = np.zeros_like(batch_x, dtype=np.float32)
        sizes = []
        for i in range(batch_x.shape[0]):
            out[i], nb = run(batch_x[i])
            sizes.append(nb)
        return out, sizes
    raise ValueError('Expected (h,w,3) or (n,h,w,3) input')


def match_quality(image, target=0.95, match='ssim', subsampling='4:4:4'):
    """Bisection search for the JPEG quality matching an SSIM or bpp target."""
    assert image.ndim == 3, 'Only RGB images supported'

    def objective(q):
        decoded, nbytes = compress_batch(image, q, subsampling=subsampling)
        if match == 'ssim':
            return metrics.ssim(image, decoded) - target
        if match == 'bpp':
            return 8.0 * nbytes / (image.shape[0] * image.shape[1]) - target
        raise ValueError('Invalid argument: match')

    low, high = 1, 95
    low_obj, high_obj = objective(low), objective(high)
    if low_obj * high_obj > 0:
        # the target lies outside what QF 1-95 reaches on this image: the nearest end
        best = low if abs(low_obj) < abs(high_obj) else high
        logger.warning(
            f'match_quality: target {target} ({match}) outside the achievable '
            f'range at QF {low}-{high}; clamping to QF {best}')
        return best
    while high - low > 1:
        if low_obj * high_obj > 0:
            raise ValueError(f'Same deviation at both end-points {low} - {high}')
        mid = (low + high) // 2
        mid_obj = objective(mid)
        if mid_obj * high_obj > 0:
            high, high_obj = mid, mid_obj
        else:
            low, low_obj = mid, mid_obj
    return low if abs(high_obj) > abs(low_obj) else high


APP_MARKERS = tuple(range(0xFFE0, 0xFFF0))


class JPEGMarkerStats:
    """
    Walk a JPEG bitstream and record the byte offsets of its markers (SOI /
    DQT / DHT / SOS / ECD / EOI) and its quantization tables, for
    effective-payload accounting (payload = total - the headers before the
    first Huffman table). The image shape comes from the SOF0 header.
    """

    def __init__(self, image):
        if isinstance(image, str):
            with open(image, 'rb') as f:
                image = f.read()
        if not isinstance(image, (bytes, bytearray)):
            raise ValueError('Image not supported! Supported: str (path) or bytes')

        self.blocks = OrderedDict()
        self.quantization_tables = {}
        self.shape = None
        self._walk(bytes(image))
        if self.shape is None:
            raise IOError('Parsing error: no SOF0 frame header')

    def _walk(self, data):
        total = len(data)
        zz = zigzag(8).ravel()
        if data[0:2] != b'\xff\xd8':
            raise IOError('Parsing error: missing SOI marker')
        self.blocks['SOI'] = 0
        pos = 2
        app_index = 0
        while pos < total - 1:
            marker = int.from_bytes(data[pos:pos + 2], 'big')
            if marker == 0xFFD9:  # EOI
                self.blocks['EOI'] = pos + 2
                return
            seg_len = int.from_bytes(data[pos + 2:pos + 4], 'big')
            payload = data[pos + 4:pos + 2 + seg_len]

            if marker == 0xFFDB:  # DQT: one or more 65-byte tables
                chunk = payload
                while len(chunk) >= 65:
                    table_id = chunk[0] & 0x0F
                    self.blocks[f'DQT:{table_id}'] = pos
                    flat = np.frombuffer(chunk[1:65], np.uint8)
                    self.quantization_tables[table_id] = flat[zz].reshape(8, 8)
                    chunk = chunk[65:]
            elif marker == 0xFFC0:
                self.blocks['DCT'] = pos
                height, width, ncomp = (int.from_bytes(payload[1:3], 'big'),
                                        int.from_bytes(payload[3:5], 'big'), payload[5])
                self.shape = (height, width, ncomp) if ncomp > 1 else (height, width)
            elif marker == 0xFFC2:
                raise NotImplementedError('Progressive JPEG images not supported yet')
            elif marker == 0xFFC4:  # DHT: one or more tables
                chunk = payload
                while chunk:
                    table_id = chunk[0]
                    self.blocks.setdefault(f'DHT:{table_id & 0x0F}', pos)
                    counts = list(chunk[1:17])
                    chunk = chunk[17 + sum(counts):]
            elif marker == 0xFFDA:  # SOS: entropy-coded data up to EOI
                self.blocks['SOS'] = pos
                self.blocks['ECD'] = pos + 2 + seg_len
                eoi = data.rfind(b'\xff\xd9')
                self.blocks['EOI'] = eoi + 2 if eoi >= 0 else total
                return
            elif marker in APP_MARKERS:
                self.blocks[f'APP:{marker & 0xF}/{app_index}'] = pos
                app_index += 1
            elif marker in (0xFFFE, 0xFFDD):
                self.blocks['RST'] = pos
            else:
                raise IOError(f'Parsing error: unknown marker {marker:#x} at {pos}')
            pos += 2 + seg_len

    def get_bytes(self):
        return self.blocks['EOI']

    def get_effective_bytes(self):
        """Bytes from the first Huffman table to the end of the file."""
        return self.blocks['EOI'] - self.blocks['DHT:0']

    def get_bpp(self):
        return 8.0 * self.get_bytes() / (self.shape[0] * self.shape[1])

    def get_effective_bpp(self):
        return 8.0 * self.get_effective_bytes() / (self.shape[0] * self.shape[1])
