"""The port's image readers without a library: ``data/png.py``'s compiled
unfilter (``csrc/png_unfilter.cpp``) against its plain Python version, and
``read_png`` and ``data/bmp.py``'s ``read_bmp`` against ``imageio.imread``;
and ``cli/pstrace.py``. Every comparison is exact: the same bytes, the same
pixels and dtype."""
import glob
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from neural_imaging_tpu_torch.cli import pstrace
from neural_imaging_tpu_torch.data import png
from neural_imaging_tpu_torch.data.bmp import read_bmp
from neural_imaging_tpu_torch.ops.hopper._build import BUILD_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_PNGS = sorted(os.path.relpath(p, ROOT)
                   for p in glob.glob(os.path.join(ROOT, 'data', '**', '*.png'), recursive=True))


def idat(filename):
    """(decompressed image data, height, stride, bytes a pixel) of an 8-bit PNG."""
    header, data = None, []
    for kind, chunk in png._chunks(open(filename, 'rb').read()):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', chunk)
        elif kind == b'IDAT':
            data.append(chunk)
    width, height, depth, colour = header[:4]
    channels = png.CHANNELS[colour]
    return zlib.decompress(b''.join(data)), height, width * channels * depth // 8, channels


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows, kinds, bpp):
    """Filter (h, stride) uint8 rows, row y with kinds[y]: the PNG encoder's side."""
    rows = rows.astype(np.int64)
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for row, kind in zip(rows, kinds):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, paeth(left, prev, upleft)][kind]
        out.append(np.concatenate([[kind], (row - pred) % 256]).astype(np.uint8))
        prev = row
    return np.concatenate(out).tobytes()


def write_filtered_png(filename, pixels, kinds):
    colour = {2: 0, 3: {2: 4, 3: 2, 4: 6}.get(pixels.shape[-1])}[pixels.ndim]
    bpp = 1 if pixels.ndim == 2 else pixels.shape[-1]
    rows = pixels.reshape(pixels.shape[0], -1)
    with open(filename, 'wb') as f:
        f.write(png.SIGNATURE
                + png._chunk(b'IHDR', struct.pack('>IIBBBBB', pixels.shape[1], pixels.shape[0],
                                                  8, colour, 0, 0, 0))
                + png._chunk(b'IDAT', zlib.compress(filter_rows(rows, kinds, bpp)))
                + png._chunk(b'IEND', b''))


# -- the compiled unfilter -----------------------------------------------------------------

def test_the_repository_has_its_pngs():
    assert len(REPO_PNGS) == 75
    shapes = [imageio.imread(os.path.join(ROOT, p)).shape[-1] for p in REPO_PNGS]
    assert shapes.count(3) == 70 and shapes.count(4) == 5


@pytest.mark.parametrize('path', REPO_PNGS)
def test_unfilter_on_repository_png(path):
    filename = os.path.join(ROOT, path)
    raw, height, stride, bpp = idat(filename)
    native = png.unfilter(raw, height, stride, bpp)
    np.testing.assert_array_equal(native, png._unfilter(raw, height, stride, bpp))
    np.testing.assert_array_equal(png.read_png(filename), imageio.imread(filename))


@pytest.mark.parametrize('bpp', [1, 2, 3, 4])
@pytest.mark.parametrize('kinds', [[0], [1], [2], [3], [4], [3, 4, 1, 0, 2, 4, 3]],
                         ids=['none', 'sub', 'up', 'average', 'paeth', 'mixed'])
def test_unfilter_every_filter(bpp, kinds):
    rng = np.random.default_rng(100 * bpp + len(kinds))
    height, width = 9, 13
    # smooth rows (the predictors matter) with noise (and wrap-around)
    base = np.cumsum(rng.integers(-9, 10, (height, width * bpp)), axis=1) + 128
    rows = (base + rng.integers(0, 3, base.shape)).astype(np.uint8)
    kinds = [kinds[y % len(kinds)] for y in range(height)]
    raw = filter_rows(rows, kinds, bpp)
    native = png.unfilter(raw, height, width * bpp, bpp)
    np.testing.assert_array_equal(native, png._unfilter(raw, height, width * bpp, bpp))
    np.testing.assert_array_equal(native, rows)


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_read_png_of_every_filter_is_imageios(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (11, 17) if channels == 1 else (11, 17, channels)
    pixels = rng.integers(0, 256, shape, dtype=np.uint8)
    filename = str(tmp_path / 'x.png')
    write_filtered_png(filename, pixels, [y % 5 for y in range(11)])
    np.testing.assert_array_equal(png.read_png(filename), imageio.imread(filename))
    np.testing.assert_array_equal(png.read_png(filename), pixels)


def test_unfilter_refuses_an_unknown_filter_and_a_short_stream():
    raw = bytearray(filter_rows(np.zeros((3, 6), np.uint8), [0, 1, 2], 3))
    raw[7] = 5                                              # row 1's filter type
    with pytest.raises(ValueError, match='unknown row filter 5 in row 1'):
        png.unfilter(bytes(raw), 3, 6, 3)
    with pytest.raises(ValueError, match='unknown row filter 5 in row 1'):
        png._unfilter(bytes(raw), 3, 6, 3)
    with pytest.raises(ValueError, match='bytes of image data'):
        png.unfilter(bytes(raw[:-1]), 3, 6, 3)


def test_unfilter_library_is_built_into_the_build_directory():
    png.library()
    path = png.library_path()
    assert path.exists() and path.parent == BUILD_DIR
    assert path.name.startswith('libpng_unfilter-') and path.suffix == '.so'


# -- read_png's colour types -----------------------------------------------------------------

def pil_image(seed, mode, h=9, w=14):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    return Image.fromarray(rgba[..., :3]).convert(mode) if mode != 'RGBA' else \
        Image.fromarray(rgba)


@pytest.mark.parametrize('mode, save', [
    ('P', {}), ('P', {'bits': 1}), ('P', {'bits': 2}), ('P', {'bits': 4}),
    ('P', {'transparency': 3}), ('LA', {}), ('L', {}), ('RGB', {}), ('RGBA', {})],
    ids=['palette-8', 'palette-1', 'palette-2', 'palette-4', 'palette-trns', 'gray-alpha',
         'gray', 'rgb', 'rgba'])
def test_read_png_colour_types_are_imageios(tmp_path, mode, save):
    """Palette PNGs come back as RGB through the palette (imageio drops tRNS
    there), gray with alpha as (h, w, 2)."""
    image = pil_image(len(save) + len(mode), mode)
    if mode == 'P' and 'bits' in save:
        image = Image.fromarray(np.asarray(image) % (1 << save['bits']), 'P')
        image.putpalette(list(np.random.default_rng(5).integers(0, 256, 3 * (1 << save['bits']))))
    filename = str(tmp_path / 'x.png')
    image.save(filename, **save)
    want = imageio.imread(filename)
    got = png.read_png(filename)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- read_bmp ----------------------------------------------------------------------------------

def write_bmp(filename, width, height, bits, rows, compression=0, masks=None, palette=None,
              header=40, top_down=False):
    """A BMP of the given (height, row bytes) pixel rows, padded to 4 bytes."""
    stride = (width * bits + 31) // 32 * 4
    data = b''.join(r.tobytes().ljust(stride, b'\0')
                    for r in (rows if top_down else rows[::-1]))
    after = struct.pack('<3I', *masks[:3]) if header == 40 and masks is not None else b''
    table = b'' if palette is None else b''.join(bytes([b, g, r, 0]) for r, g, b in palette)
    info = struct.pack('<IiiHHIIiiII', header, width, -height if top_down else height, 1, bits,
                       compression, len(data), 2835, 2835,
                       0 if palette is None else len(palette), 0)
    if header > 40:
        info += struct.pack('<4I', *(list(masks or ()) + [0] * 4)[:4]) + bytes(header - 56)
    offset = 14 + len(info) + len(after) + len(table)
    with open(filename, 'wb') as f:
        f.write(b'BM' + struct.pack('<IHHI', offset + len(data), 0, 0, offset) + info + after
                + table + data)


@pytest.mark.parametrize('mode', ['1', 'L', 'P', 'RGB', 'RGBA'])
@pytest.mark.parametrize('width', [13, 16])
def test_read_bmp_of_pillow_is_imageios(tmp_path, mode, width):
    filename = str(tmp_path / 'x.bmp')
    pil_image(width, mode, w=width).save(filename)
    want = imageio.imread(filename)
    got = read_bmp(filename)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def bmp_cases():
    rng = np.random.default_rng(7)
    h, w = 7, 13
    index4 = rng.integers(0, 16, (h, w), dtype=np.uint8)
    packed4 = np.packbits(np.unpackbits(index4[..., None], axis=2)[..., 4:].reshape(h, -1),
                          axis=1)
    v16 = rng.integers(0, 1 << 16, (h, w)).astype('<u2').view(np.uint8).reshape(h, -1)
    v32 = rng.integers(0, 1 << 32, (h, w)).astype('<u4').view(np.uint8).reshape(h, -1)
    rgb = rng.integers(0, 256, (h, 3 * w), dtype=np.uint8)
    palette = [tuple(int(x) for x in rng.integers(0, 256, 3)) for _ in range(16)]
    return {
        'rgb4': dict(bits=4, rows=packed4, palette=palette),
        'rgb16-555': dict(bits=16, rows=v16),
        'bitfields16-565': dict(bits=16, rows=v16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        'bitfields16-555-top-down': dict(bits=16, rows=v16, compression=3,
                                         masks=(0x7C00, 0x3E0, 0x1F), top_down=True),
        'bitfields32-xrgb': dict(bits=32, rows=v32, compression=3,
                                 masks=(0xFF0000, 0xFF00, 0xFF)),
        'bitfields32-argb-v5': dict(bits=32, rows=v32, compression=3, header=124,
                                    masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        'bitfields32-abgr-v3': dict(bits=32, rows=v32, compression=3, header=56,
                                    masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
        'rgb24-top-down': dict(bits=24, rows=rgb, top_down=True),
    }


@pytest.mark.parametrize('case', list(bmp_cases()))
def test_read_bmp_layouts_are_imageios(tmp_path, case):
    filename = str(tmp_path / 'x.bmp')
    write_bmp(filename, 13, 7, **bmp_cases()[case])
    want = imageio.imread(filename)
    got = read_bmp(filename)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('compression, message', [(1, 'BI_RLE8'), (2, 'BI_RLE4'), (4, 'BI_JPEG'),
                                                  (9, 'compression 9')])
def test_read_bmp_refuses_compressed_files(tmp_path, compression, message):
    filename = str(tmp_path / 'x.bmp')
    write_bmp(filename, 4, 2, 8, np.zeros((2, 4), np.uint8), compression=compression,
              palette=[(i, 0, 0) for i in range(256)])
    with pytest.raises(ValueError, match=message):
        read_bmp(filename)


def test_read_bmp_refuses_what_is_not_a_bmp(tmp_path):
    filename = str(tmp_path / 'x.bmp')
    with open(filename, 'wb') as f:
        f.write(b'XX' + bytes(60))
    with pytest.raises(ValueError, match='not a BMP'):
        read_bmp(filename)
    # a header cut short, and a palette larger than the bits can index
    write_bmp(filename, 4, 2, 4, np.zeros((2, 2), np.uint8), palette=[(9, 9, 9)] * 17)
    with pytest.raises(ValueError, match='palette of 17 colours'):
        read_bmp(filename)
    with open(filename, 'rb') as f:
        blob = f.read()
    with open(filename, 'wb') as f:
        f.write(blob[:30])
    with pytest.raises(ValueError, match='truncated BMP header'):
        read_bmp(filename)


# -- pstrace -----------------------------------------------------------------------------------

def test_pstrace_samples_this_process(tmp_path, capsys):
    csv = str(tmp_path / 'trace.csv')
    samples = pstrace.main([str(os.getpid()), '--interval', '0.2', '--duration', '0.5',
                            '--csv', csv])
    assert 2 <= len(samples) <= 3
    rss, jiffies = pstrace.read_proc(os.getpid())
    assert all(0 < s[1] <= 2 * rss for s in samples) and jiffies > 0
    assert samples[0][2] == 0.0 and all(s[2] >= 0 for s in samples)
    lines = open(csv).read().splitlines()
    assert lines[0] == 'time,rss_mb,cpu_pct' and len(lines) == 1 + len(samples)
    assert capsys.readouterr().out.count(f'pid={os.getpid()} ') == len(samples)


def test_pstrace_stops_when_the_process_is_gone(capsys):
    assert pstrace.main(['999999999', '--duration', '5']) == []
    assert 'process 999999999 exited' in capsys.readouterr().out
