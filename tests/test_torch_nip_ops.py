"""The ops the port's camera ISPs and their losses use (``small_conv2d``,
``percentile_normalize``, ``psnr`` / ``batch_psnr``, ``gaussian_kernel_2d``,
``ms_ssim`` and the MS-SSIM loss, ``merge_bayer``) and the stateless
``tensor_isp``, against the JAX package's, on the CPU.

Tolerances: values within 1e-5 (float32, other summation orders; the
percentile normalization and MS-SSIM within 1e-6 and 1e-5 relative) and
gradients within ``GRAD_RTOL`` (1e-4) of their largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_imaging_tpu.data import bayer as jbayer
from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu.ops import ops as jops
from neural_imaging_tpu.ops import ssim as jssim
from neural_imaging_tpu_torch.data import bayer
from neural_imaging_tpu_torch.models import pipelines
from neural_imaging_tpu_torch.ops import ops, ssim

torch.set_num_threads(1)

FWD_ATOL, GRAD_RTOL = 1e-5, 1e-4


# -- ops -------------------------------------------------------------------------------

@pytest.mark.parametrize('shape,padding', [((5, 5, 3, 3), 'SAME'), ((4, 4, 3, 2), 'SAME'),
                                           ((1, 1, 4, 12), 'SAME'), ((5, 5, 3, 3), 'VALID'),
                                           ((3, 3, 2, 3), ((1, 2), (0, 1)))])
def test_small_conv2d_matches_reference(shape, padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 11, shape[2])).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    expected = np.asarray(jops.small_conv2d(jnp.asarray(x), k, padding=padding))
    got = ops.small_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), k, padding=padding)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), expected, atol=FWD_ATOL)


def test_small_conv2d_keeps_the_input_dtype_and_sums_in_float32():
    x = torch.rand(1, 3, 8, 8).to(torch.bfloat16)
    k = np.random.default_rng(2).standard_normal((3, 3, 3, 3)).astype(np.float32)
    y = ops.small_conv2d(x, k)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, F.conv2d(F.pad(x.float(), (1, 1, 1, 1)),
                                           ops.hwio_to_oihw(k)).to(torch.bfloat16))


@pytest.mark.parametrize('shape', [(2, 8, 8, 3), (3, 17, 13, 3), (1, 64, 64, 3)])
def test_percentile_normalize_matches_reference(shape):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    w = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    expected = np.asarray(jops.percentile_normalize(jnp.asarray(x), 0.5))
    # jitted, as the reference's models run it: op by op, XLA computes the
    # interpolation weights of the top percentile one float32 ulp of its
    # position apart (0.1% of the gradient split between its two samples)
    g_ref = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(jops.percentile_normalize(t, 0.5) * w)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = ops.percentile_normalize(xt, 0.5)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), expected, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, atol=GRAD_RTOL * np.abs(g_ref).max())


def test_psnr_and_gaussian_kernel_match_reference():
    a = np.random.default_rng(6).random((3, 8, 8, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * np.random.default_rng(7).standard_normal(a.shape), 0, 1)
    b = b.astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(ops.psnr(ta, tb)), float(jops.psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(ops.batch_psnr(ta, tb).numpy(), np.asarray(jops.batch_psnr(a, b)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ops.psnr(ta, ta)), float(jops.psnr(a, a)))   # the floor
    np.testing.assert_allclose(ops.gaussian_kernel_2d(7, 1.5).numpy(),
                               np.asarray(jops.gaussian_kernel_2d(7, 1.5)), atol=1e-8)


@pytest.mark.parametrize('size', [128, 64, 45, 11])
def test_ms_ssim_matches_reference(size):
    """The pyramid and its truncation: 128 px keeps four scales, 64 px three,
    45 px (odd sides, padded) three, 11 px one."""
    rng = np.random.default_rng(size)
    a = rng.random((2, size, size, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    expected = np.asarray(jssim.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = ssim.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_msssim_loss_and_gradient_match_reference():
    rng = np.random.default_rng(8)
    a = rng.random((2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    loss_ref, g_ref = jax.value_and_grad(lambda t: jops.msssim_loss(jnp.asarray(a), t))(
        jnp.asarray(b))
    bt = torch.from_numpy(b).requires_grad_()
    loss = ops.LOSSES['MS-SSIM'](torch.from_numpy(a), bt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(bt.grad.numpy(), g_ref, atol=GRAD_RTOL * np.abs(g_ref).max())


@pytest.mark.parametrize('cfa', ['GBRG', 'RGGB', 'BGGR', 'GRBG'])
def test_merge_bayer_matches_reference(cfa):
    stack = np.random.default_rng(9).random((1, 6, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(bayer.merge_bayer(stack, cfa), jbayer.merge_bayer(stack, cfa))
    with pytest.raises(ValueError):
        bayer.merge_bayer(np.zeros((2, 4, 4, 4)), cfa)


@pytest.mark.parametrize('brightness', ['percentile', 'shift', None])
def test_tensor_isp_matches_reference(brightness):
    x = np.stack([fixtures.make_raw_rgb_pair(32, 32, seed=s)[0] for s in (13, 14)])
    x = x.astype(np.float32) / 65535.0
    srgb = np.array([[1.6, -0.4, -0.2], [-0.1, 1.3, -0.2], [0.0, -0.3, 1.3]])
    expected = np.asarray(jpipelines.tensor_isp(x, srgb, 'rggb', brightness))
    got = pipelines.tensor_isp(torch.from_numpy(x), srgb, 'rggb', brightness).numpy()
    np.testing.assert_allclose(got, expected, atol=FWD_ATOL)
