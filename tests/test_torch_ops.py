"""Parity of the PyTorch port's ops (neural_imaging_tpu_torch.ops) with the JAX
package on the CPU. Inputs come from numpy; JAX takes NHWC, the port NCHW.

Tolerances: both sides compute in float32 with different summation orders,
so values in [0, 1] agree to about 1e-6 and 255-scaled values to about
1e-4; exact ops (padding, reshapes, rounding) agree bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_imaging_tpu.compression import jpeg_helpers as jax_jpeg_helpers
from neural_imaging_tpu.ops import color as jcolor
from neural_imaging_tpu.ops import dct as jdct
from neural_imaging_tpu.ops import kernels as jkernels
from neural_imaging_tpu.ops import manipulations as jmanips
from neural_imaging_tpu.ops import ops as jops
from neural_imaging_tpu.ops import quantization as jquant
from neural_imaging_tpu.ops import ssim as jssim
from neural_imaging_tpu_torch.compression import jpeg_helpers
from neural_imaging_tpu_torch.ops import (color, dct, kernels, manipulations, ops, quantization,
                                          ssim)

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def images(seed, shape=(2, 16, 16, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize('name', ['rgb_to_ycbcr', 'ycbcr_to_rgb'])
def test_ycbcr(name):
    x = images(0) * 255
    ref = getattr(jcolor, name)(jnp.asarray(x))
    out = getattr(color, name)(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-4)


def test_hsv_round_trip_and_parity():
    x = images(1)
    x[0, :4, :4] = 0.5          # grey pixels: zero range, hue 0
    x[1, :2, :2] = 0.0          # black pixels: zero value
    hsv = color.rgb_to_hsv(nchw(x))
    np.testing.assert_allclose(nhwc(hsv), np.asarray(jcolor.rgb_to_hsv(jnp.asarray(x))),
                               atol=1e-6)
    rgb = color.hsv_to_rgb(hsv)
    np.testing.assert_allclose(nhwc(rgb), np.asarray(jcolor.hsv_to_rgb(
        jcolor.rgb_to_hsv(jnp.asarray(x)))), atol=1e-6)
    np.testing.assert_allclose(nhwc(rgb), x, atol=1e-6)


def test_dct_matrix_is_the_reference_matrix():
    np.testing.assert_array_equal(dct.dct_matrix(8), jdct.dct_matrix(8))
    assert dct.dct_matrix(8).dtype == np.float32


def test_blockify_layout_and_dct_parity():
    x = images(2, (2, 16, 24, 3)) * 255 - 127
    blocks = dct.blockify(nchw(x))
    jblocks = jdct.blockify(jnp.asarray(x))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
    np.testing.assert_array_equal(nhwc(dct.deblockify(blocks)), x)
    coeffs = dct.dct2d(blocks)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(jdct.dct2d(jblocks)), atol=1e-3)
    np.testing.assert_allclose(dct.idct2d(coeffs).numpy(), blocks.numpy(), atol=1e-3)


@pytest.mark.parametrize('mode', ['round', 'sin', 'soft', 'harmonic', 'identity'])
def test_quantize_modes(mode):
    x = np.random.default_rng(3).standard_normal(256).astype(np.float32) * 5
    x[:4] = [0.5, 1.5, -2.5, 2.5]      # ties round half to even on both sides
    out = quantization.quantize(torch.from_numpy(x), mode, taylor_terms=5)
    ref = jquant.quantize(jnp.asarray(x), mode, taylor_terms=5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_soft_quantize_gradient_is_the_sin_derivative():
    x = torch.linspace(-2, 2, 33, requires_grad=True)
    quantization.quantize(x, 'soft').sum().backward()
    g_ref = jax.grad(lambda v: jquant.quantize(v, 'soft').sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=1e-5)


def test_depth_to_space_uses_tf_channel_order():
    x = images(4, (2, 5, 6, 12))
    out = ops.depth_to_space(nchw(x), 2)
    np.testing.assert_array_equal(nhwc(out), np.asarray(jops.depth_to_space(jnp.asarray(x), 2)))
    # and not pixel_shuffle's order
    assert not np.array_equal(out.numpy(), torch.nn.functional.pixel_shuffle(nchw(x), 2).numpy())


@pytest.mark.parametrize('mode', ['symmetric', 'reflect', 'constant'])
@pytest.mark.parametrize('pad', [1, 2])
def test_pad2d(mode, pad):
    x = images(5, (2, 7, 9, 3))
    out = ops.pad2d(nchw(x), pad, mode)
    np.testing.assert_array_equal(nhwc(out), np.asarray(jops.pad2d(jnp.asarray(x), pad, mode)))


def test_leaky_relu_slope():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    out = ops.ACTIVATIONS['leaky_relu'](torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.ACTIVATIONS['leaky_relu'](x)),
                               atol=1e-7)
    assert float(ops.leaky_relu(torch.tensor(-1.0))) == pytest.approx(-0.2)


def test_avg_max_and_global_pool():
    x = images(6, (2, 8, 12, 3))
    np.testing.assert_allclose(nhwc(ops.avg_pool(nchw(x), 2)),
                               np.asarray(jops.avg_pool(jnp.asarray(x), 2)), atol=1e-7)
    np.testing.assert_array_equal(nhwc(ops.max_pool(nchw(x), 2)),
                                  np.asarray(jops.max_pool(jnp.asarray(x), 2)))
    np.testing.assert_allclose(ops.global_average_pool(nchw(x)).numpy(),
                               np.asarray(jops.global_average_pool(jnp.asarray(x))), atol=1e-6)
    with pytest.raises(ValueError):
        ops.avg_pool(nchw(images(6, (1, 7, 8, 3))), 2)


def test_st_clip_value_and_gradient():
    x = torch.tensor([-0.5, 0.25, 1.5], requires_grad=True)
    y = ops.st_clip(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jops.st_clip(jnp.asarray(x.detach().numpy()))))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(3, np.float32))


@pytest.mark.parametrize('padding', ['SAME', 'VALID'])
@pytest.mark.parametrize('k', [1, 3, 4, 5])
def test_conv2d(padding, k):
    x = images(7, (2, 9, 10, 3))
    w = np.random.default_rng(8).standard_normal((k, k, 3, 4)).astype(np.float32)
    out = ops.conv2d(nchw(x), ops.hwio_to_oihw(w), padding=padding)
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(w), padding=padding)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('mode', ['reflect', 'symmetric'])
@pytest.mark.parametrize('per_channel', [False, True])
def test_depthwise_conv2d(mode, per_channel):
    x = images(9, (2, 10, 12, 3))
    shape = (5, 5, 3) if per_channel else (5, 5)
    k = np.random.default_rng(10).random(shape).astype(np.float32)
    out = ops.depthwise_conv2d(nchw(x), k, mode)
    ref = jops.depthwise_conv2d(jnp.asarray(x), k, mode)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('n_in,n_out', [(16, 8), (32, 16), (16, 4), (8, 16), (10, 5), (12, 7),
                                         (230, 172), (209, 256), (256, 104), (32, 26)])
def test_resize_matrix_matches_jax_image_resize(n_in, n_out):
    m = manipulations._resize_matrix(n_in, n_out)
    ref = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in),
                                      method='bilinear'))
    np.testing.assert_allclose(m, ref, atol=1e-6)
    np.testing.assert_allclose(m, jmanips._resize_matrix(n_in, n_out), atol=1e-6)


@pytest.mark.parametrize('factor', [50, 75, 0.5])
def test_resample(factor):
    x = images(11, (2, 16, 16, 3))
    out = manipulations.resample(nchw(x), factor)
    ref = jmanips.resample(jnp.asarray(x), factor)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)
    down = jax.image.resize(jnp.asarray(x), (2, 8, 8, 3), method='bilinear')
    np.testing.assert_allclose(nhwc(manipulations.resize_bilinear(nchw(x), 8, 8)),
                               np.asarray(down), atol=1e-6)


@pytest.mark.parametrize('strength', [0.5, 1.0, 1.5])
@pytest.mark.parametrize('hsv', [True, False])
def test_sharpen(strength, hsv):
    x = images(12)
    out = manipulations.sharpen(nchw(x), strength, hsv=hsv)
    ref = jmanips.sharpen(jnp.asarray(x), strength, hsv=hsv)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('std', [0.5, 0.83, 2.0])
def test_gaussian(std):
    x = images(13)
    np.testing.assert_allclose(nhwc(manipulations.gaussian(nchw(x), 5, std)),
                               np.asarray(jmanips.gaussian(jnp.asarray(x), 5, std)), atol=1e-6)


def test_manipulation_registry_covers_the_slice():
    assert set(manipulations.MANIPULATIONS) == {'sharpen', 'resample', 'gaussian', 'jpeg', 'awgn',
                                                'gamma', 'median'}
    for name, strength in manipulations.DEFAULT_STRENGTHS.items():
        assert jmanips.DEFAULT_STRENGTHS[name] == strength


@pytest.mark.parametrize('name,args', [
    ('upsampling_kernel', ('gbrg',)), ('upsampling_kernel', ('rggb',)),
    ('upsampling_kernel', ('bggr',)), ('gamma_kernels', ()), ('bilin_kernel', (5,)),
    ('gkern', (5, 0.83)), ('repeat_2dfilter', (np.arange(9.0).reshape(3, 3), 3)),
    ('center_mask_2dfilter', (5, 3))])
def test_filter_functions_are_the_reference_filters(name, args):
    out = getattr(kernels, name)(*args)
    ref = getattr(jkernels, name)(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('quality', [1, 10, 50, 80, 95, 100])
@pytest.mark.parametrize('channel', [0, 1])
def test_qtables(quality, channel):
    np.testing.assert_array_equal(jpeg_helpers.jpeg_qtable(quality, channel),
                                  jax_jpeg_helpers.jpeg_qtable(quality, channel))


# TF 'SAME' at stride 2 pads asymmetrically: for k=5 on an even size (1, 2),
# on an odd size (2, 2); a symmetric padding of 2 is off by one pixel.
@pytest.mark.parametrize('size,kernel,stride', [(16, 5, 2), (15, 5, 2), (16, 3, 2), (17, 3, 2),
                                                (12, 5, 1), (13, 4, 1)])
def test_conv2d_same_matches_lax_at_any_stride(size, kernel, stride):
    rng = np.random.default_rng(size * kernel + stride)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), 'SAME',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        precision=jax.lax.Precision.HIGHEST) + b
    out = ops.conv2d(nchw(x), ops.hwio_to_oihw(w), 'SAME', stride, torch.from_numpy(b))
    assert nhwc(out).shape == ref.shape == (2, -(-size // stride), -(-(size + 1) // stride), 4)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)


def test_ssim_matches_the_reference():
    a = images(20, (2, 24, 28, 3))
    b = np.clip(a + 0.1 * np.random.default_rng(21).standard_normal(a.shape), 0, 1
                ).astype(np.float32)
    per_channel = ssim.ssim_per_channel(torch.from_numpy(a), torch.from_numpy(b))
    ref_per_channel = jssim.ssim_per_channel(jnp.asarray(a), jnp.asarray(b))
    for out, ref in zip(per_channel, ref_per_channel):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(ssim.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jssim.ssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.float32, np.float64])
def test_normalize_batch(dtype):
    x = (images(22) * (np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else 1)
         ).astype(dtype)
    out = ops.normalize_batch(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jops.normalize_batch(jnp.asarray(x))))


def test_l2_loss():
    x = images(23) - 0.5
    np.testing.assert_allclose(float(ops.l2_loss(torch.from_numpy(x))),
                               float(jops.l2_loss(jnp.asarray(x))), rtol=1e-6)
