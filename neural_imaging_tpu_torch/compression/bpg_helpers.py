"""
BPG (HEVC still-image) codec bridge via the bpgenc/bpgdec binaries, with
bitstream header parsing for the payload count. Port of
``neural_imaging_tpu/compression/bpg_helpers.py``, with the port's PNG
reader and writer in place of imageio.

The entry points raise when the binaries are absent, and the rate-distortion
sweep's BPG leg is then empty, as in the JAX package. Neither package uses
``compression/hevc.py`` as a backend here.
"""
import os
import shutil
import subprocess
import tempfile

import numpy as np

from neural_imaging_tpu_torch.data.png import read_png, write_png

BPGENC = shutil.which('bpgenc')
BPGDEC = shutil.which('bpgdec')


def bpg_available():
    return BPGENC is not None and BPGDEC is not None


def _require_bpg():
    if not bpg_available():
        raise RuntimeError('bpgenc/bpgdec binaries are not available in this environment')


def _read_ue7(data, pos):
    """Read a BPG ue7 (7-bit-per-byte varint) value; returns (value, new_pos)."""
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def bpg_header_info(filename):
    """Parse the BPG header; returns dict with width/height/payload length."""
    with open(filename, 'rb') as f:
        data = f.read()
    if data[:4] != b'BPG\xfb':
        raise ValueError('Not a BPG file')
    pos = 4
    _fmt = data[pos]                    # pixel_format(3) alpha1(1) depth-8(4)
    pos += 1
    flags = data[pos]                   # color_space(4) ext(1) alpha2(1) range(1) anim(1)
    pos += 1
    width, pos = _read_ue7(data, pos)
    height, pos = _read_ue7(data, pos)
    picture_data_length, pos = _read_ue7(data, pos)
    extension_present = (flags >> 3) & 1
    if extension_present:
        ext_len, pos = _read_ue7(data, pos)
        pos += ext_len
    payload = picture_data_length if picture_data_length else len(data) - pos
    return {'width': width, 'height': height, 'payload_bytes': payload,
            'total_bytes': len(data)}


def compress(image, quality=28, out_file=None):
    """Encode an RGB [0,1] image with bpgenc; returns (bpg_path, n_bytes)."""
    _require_bpg()
    fd, tmp_png = tempfile.mkstemp(suffix='.png')
    os.close(fd)
    if out_file is None:
        fd, out_file = tempfile.mkstemp(suffix='.bpg')
        os.close(fd)
    try:
        write_png(tmp_png, (np.clip(image, 0, 1) * 255).astype(np.uint8))
        subprocess.run([BPGENC, '-q', str(quality), '-o', out_file, tmp_png], check=True)
    finally:
        os.remove(tmp_png)
    return out_file, os.path.getsize(out_file)


def decompress(bpg_file):
    """Decode a BPG file back to float RGB [0,1]."""
    _require_bpg()
    fd, tmp_png = tempfile.mkstemp(suffix='.png')
    os.close(fd)
    try:
        subprocess.run([BPGDEC, '-o', tmp_png, bpg_file], check=True)
        return read_png(tmp_png).astype(np.float32) / 255.0
    finally:
        os.remove(tmp_png)


def roundtrip(image, quality=28):
    """Full encode/decode; returns (decoded, payload_bpp)."""
    bpg_file, _ = compress(image, quality)
    try:
        info = bpg_header_info(bpg_file)
        decoded = decompress(bpg_file)
    finally:
        os.remove(bpg_file)
    bpp = 8.0 * info['payload_bytes'] / (image.shape[0] * image.shape[1])
    return decoded, bpp
