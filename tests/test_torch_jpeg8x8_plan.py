"""K1's launch geometry (``jpeg8x8.launch_plan``) and a numpy model of the
kernel's walk, on the CPU.

The kernel (``csrc/jpeg8x8.cu``) gives each warp a group of 4 neighbouring
8x8 tiles at a time: warp w of a launch of grid x block / 32 warps takes
groups w, w + stride, ... (stride = its number of warps), lanes 8b + l on
tile 4g + b, splits the tile index into plane, tile row and tile column, and
runs the four passes on the tile, each output a chain of FMAs from 0 (lane l
on column l for the column passes, on row l for the row passes). ``walk``
and ``model`` below repeat that index arithmetic and that order in numpy
(the FMA emulated in float64, rounded to float32), a step of the warps'
loop at a time.
Tests: at every shape the paths launch K1 at, and at ragged ones, the walk
takes each tile and so each pixel exactly once within the launch limits, and
the model's result holds against ``jpeg_core_plain`` (and the JAX package's
Pallas kernel in interpret mode) by ``jpeg8x8.check_cores``; the DCT matrix
compiled into the kernel is the reference's, bit for bit."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_imaging_tpu.compression.jpeg_helpers import jpeg_qtable
from neural_imaging_tpu.ops import dct as jax_dct
from neural_imaging_tpu.ops.pallas import jpeg8x8 as jax_k1
from neural_imaging_tpu_torch.ops import dct as dct_ops
from neural_imaging_tpu_torch.ops.hopper import jpeg8x8

torch.set_num_threads(1)

# (P, H, W) of K1's launches on the paths (chip_smoke.py's [k1] tally): the
# m_quality request and step's two (manipulation jpeg:80, channel QF50), the
# 8-class channel, the DCN flow's jpeg:80 (and the UNet/DNet steps'
# manipulation), the UNet/DNet steps' channel, test_jpeg's 512x768 image
# after 2x chroma subsampling, the trainer's two at batch 10
PATH_SHAPES = [(60, 256, 256), (300, 128, 128), (480, 128, 128), (30, 128, 128),
               (150, 64, 64), (12, 256, 384), (30, 256, 256), (150, 128, 128)]
# ragged: a lone tile, widths that are not a multiple of 16 or 32 tiles, one
# tile row across the D90's width, the D90's whole image (2848x4288)
EDGE_SHAPES = [(1, 8, 8), (3, 64, 136), (3, 48, 392), (3, 8, 4288), (3, 2848, 4288)]
# every shape but the whole D90 image (~10 s of numpy) runs through the model
MODEL_SHAPES = PATH_SHAPES + EDGE_SHAPES[:-1]


def walk(p, h, w):
    """The kernel's walk on planes (P, H, W): a list, one entry per step of
    the warps' loop, of (warp ids, tile ids): one entry per tile that a lane
    group of a warp takes at that step."""
    grid, block = jpeg8x8.launch_plan(p, h, w)
    tiles = p * (h // 8) * (w // 8)
    per_group = jpeg8x8.TILES_PER_WARP
    groups = -(-tiles // per_group)
    stride = grid * block // 32
    warp = np.arange(stride, dtype=np.int64)
    steps = []
    for i in range(-(-groups // stride)):
        g = warp + i * stride
        live = g < groups
        t = (g[live, None] * per_group + np.arange(per_group)).reshape(-1)
        owner = np.repeat(warp[live], per_group)
        active = t < tiles                              # the last group's lanes past the end
        steps.append((owner[active], t[active]))
    return steps


def tile_offsets(t, h, w):
    """Flat offsets (n, 8, 8) of the pixels of tiles ``t`` as the kernel
    computes them: t → plane, tile row, tile column → the tile's first pixel,
    then row m at + m W."""
    tiles_w = w // 8
    tiles_plane = (h // 8) * tiles_w
    p = t // tiles_plane
    r = t - p * tiles_plane
    bh = r // tiles_w
    bw = r - bh * tiles_w
    at = (p * h + 8 * bh) * w + 8 * bw
    return at[:, None, None] + np.arange(8)[:, None] * w + np.arange(8)


def fma(a, b, acc):
    """fmaf in float64 (the product of two float32 values is exact there),
    rounded to float32."""
    return (a.astype(np.float64) * b + acc).astype(np.float32)


def model(planes, q):
    """K1 as the kernel computes it, thread by thread along ``walk``: each
    step takes every live thread's tile at once."""
    p, h, w = planes.shape
    d = dct_ops.dct_matrix()
    x = planes.reshape(-1)
    y = np.full_like(x, np.nan)
    c = np.full_like(x, np.nan)
    tiles_plane = (h // 8) * (w // 8)
    for _, t in walk(p, h, w):
        at = tile_offsets(t, h, w)
        b = x[at]                                           # (n, 8, 8): [row][column]
        qt = q[t // tiles_plane]
        zero = np.zeros(len(t), np.float32)
        col = np.empty_like(b)                              # t[k][l] = sum_m D[k][m] x[m][l]
        for l in range(8):
            for k in range(8):
                acc = zero
                for m in range(8):
                    acc = fma(d[k, m], b[:, m, l], acc)
                col[:, k, l] = acc
        t2 = np.empty_like(b)
        coef = np.empty_like(b)
        for k in range(8):
            s = np.empty((len(t), 8), np.float32)           # X[k][l] = sum_m t[k][m] D[l][m]
            for l in range(8):
                acc = zero
                for m in range(8):
                    acc = fma(col[:, k, m], d[l, m], acc)
                s[:, l] = acc
            s = np.rint(s / qt[:, k]) * qt[:, k]
            coef[:, k] = s
            for l in range(8):                              # t2[k][l] = sum_j Xq[k][j] D[j][l]
                acc = zero
                for j in range(8):
                    acc = fma(s[:, j], d[j, l], acc)
                t2[:, k, l] = acc
        out = np.empty_like(b)                              # y[m][l] = sum_k D[k][m] t2[k][l]
        for m in range(8):
            for l in range(8):
                acc = zero
                for k in range(8):
                    acc = fma(d[k, m], t2[:, k, l], acc)
                out[:, m, l] = acc
        y[at] = out
        c[at] = coef
    return y.reshape(planes.shape), c.reshape(planes.shape)


def planes_and_tables(seed, p, h, w, quality=80):
    rng = np.random.default_rng(seed)
    planes = (rng.random((p, h, w)) * 255 - 127).astype(np.float32)
    q = np.stack([jpeg_qtable(quality, min(i % 3, 1)) for i in range(p)])
    return planes, q


@pytest.mark.parametrize('p,h,w', PATH_SHAPES + EDGE_SHAPES)
def test_plan_stays_within_the_launch_limits(p, h, w):
    grid, block = jpeg8x8.launch_plan(p, h, w)
    tiles = p * (h // 8) * (w // 8)
    groups = -(-tiles // jpeg8x8.TILES_PER_WARP)
    resident = jpeg8x8.SMS * jpeg8x8.RESIDENT_WARPS
    assert block in (32, 64, 128, 256) and 1 <= grid < 2 ** 31
    warps = grid * block // 32
    assert warps + groups < 2 ** 32                     # g += warps never wraps
    per_warp = -(-groups // warps)
    if groups > resident:
        # every resident slot filled where that gives no warp more than
        # ONE_WAVE_GROUPS, else at most the cap each; shares differ by at
        # most one group
        assert block == jpeg8x8.MAX_BLOCK and warps >= resident
        if groups <= jpeg8x8.ONE_WAVE_GROUPS * resident:
            assert warps - resident < block // 32
            assert per_warp <= jpeg8x8.ONE_WAVE_GROUPS
        else:
            assert per_warp <= jpeg8x8.MAX_GROUPS_PER_WARP
        assert groups > (per_warp - 1) * warps
    else:
        # one group a warp, over at least two blocks an SM where there are
        # enough warps for that
        assert per_warp == 1 and warps - groups < block // 32
        assert grid >= min(2 * jpeg8x8.SMS, groups)


@pytest.mark.parametrize('p,h,w', PATH_SHAPES + EDGE_SHAPES)
def test_walk_takes_every_tile_exactly_once(p, h, w):
    tiles = p * (h // 8) * (w // 8)
    taken = np.concatenate([t for _, t in walk(p, h, w)])
    assert np.array_equal(np.bincount(taken, minlength=tiles), np.ones(tiles, np.int64))
    # each warp walks its groups at the stride, in increasing order
    steps = walk(p, h, w)
    for (w0, t0), (w1, t1) in zip(steps, steps[1:]):
        assert np.array_equal(w1, w0[:len(w1)]) and np.all(t1 > t0[:len(t1)])


@pytest.mark.parametrize('p,h,w', [s for s in PATH_SHAPES + EDGE_SHAPES
                                   if s[0] * s[1] * s[2] <= 2 ** 23])
def test_tiles_cover_every_pixel_exactly_once(p, h, w):
    offsets = np.concatenate([tile_offsets(t, h, w).reshape(-1) for _, t in walk(p, h, w)])
    assert np.array_equal(np.bincount(offsets, minlength=p * h * w),
                          np.ones(p * h * w, np.int64))


def test_whole_d90_image_tiles_stay_inside_their_planes():
    p, h, w = 3, 2848, 4288
    for _, t in walk(p, h, w):
        corners = tile_offsets(t, h, w)[:, [0, -1], [0, -1]]   # first and last pixel
        plane = corners // (h * w)
        assert np.array_equal(plane[:, 0], plane[:, 1])
        assert np.all(corners[:, 1] - corners[:, 0] == 7 * w + 7)
        assert corners.min() >= 0 and corners.max() < p * h * w


@pytest.mark.parametrize('p,h,w', MODEL_SHAPES)
def test_model_of_the_walk_matches_the_plain_core(p, h, w):
    planes, q = planes_and_tables(p * h + w, p, h, w)
    y, c = model(planes, q)
    assert np.isfinite(y).all() and np.isfinite(c).all()   # every pixel written
    y_ref, c_ref = jpeg8x8.jpeg_core_plain(torch.from_numpy(planes), torch.from_numpy(q))
    jpeg8x8.check_cores(torch.from_numpy(y), torch.from_numpy(c), y_ref, c_ref,
                        torch.from_numpy(q))


@pytest.mark.parametrize('p,h,w', [(1, 8, 8), (3, 16, 136)])
def test_model_of_the_walk_matches_pallas_interpret(p, h, w):
    planes, q = planes_and_tables(p + h + w, p, h, w, quality=50)
    y, c = model(planes, q)
    y_ref, c_ref = jax_k1.jpeg_core_pallas(jnp.asarray(planes), jnp.asarray(q), True)
    jpeg8x8.check_cores(*[torch.as_tensor(np.array(a)) for a in (y, c, y_ref, c_ref, q)])


def test_plan_refuses_more_tiles_than_the_index_holds():
    with pytest.raises(ValueError, match='tiles'):
        jpeg8x8.launch_plan(2 ** 16, 2 ** 12, 2 ** 12)


def test_compiled_dct_matrix_is_the_reference_matrix_bit_for_bit():
    source = (Path(jpeg8x8.__file__).resolve().parents[2] / 'csrc' / 'jpeg8x8.cu').read_text()
    table = source[source.index('#define K1_DCT_MATRIX'):]
    table = table[:table.index('}') + 1]
    values = [float.fromhex(v) for v in re.findall(r'-?0x[0-9a-f.]+p[-+]?\d+', table)]
    compiled = np.array(values, np.float32).reshape(8, 8)
    assert np.array_equal(compiled.view(np.int32), dct_ops.dct_matrix().view(np.int32))
    # the matrix the reference's Pallas kernel takes
    assert np.array_equal(compiled.view(np.int32),
                          np.asarray(jax_dct.dct_matrix(8), np.float32).view(np.int32))
