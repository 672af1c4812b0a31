"""Parity of the port's differentiable JPEG (K1's plain version, the codec and
its wrappers) with the JAX package on the CPU, where the JAX side runs the
Pallas kernel in interpret mode or its XLA form.

Tolerances (``jpeg8x8.check_cores``, shared with chip_smoke.py): the
255-scaled reconstructions agree to 1e-4 (float32, different summation
orders) in every 8x8 block whose coefficients agree. A last-bit difference
before rounding can flip one coefficient by a whole q step, so flipped
coefficients are counted and bounded (at most 1 in 1000), not compared bit
for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_imaging_tpu.compression.jpeg_helpers import jpeg_qtable
from neural_imaging_tpu.models import jpeg as jax_jpeg
from neural_imaging_tpu.ops.pallas import jpeg8x8 as jax_k1
from neural_imaging_tpu_torch.models import jpeg
from neural_imaging_tpu_torch.ops.hopper import jpeg8x8

torch.set_num_threads(1)

MAX_FLIP_SHARE = jpeg8x8.MAX_FLIP_SHARE


def planes_and_tables(seed, p=3, h=16, w=16, quality=50):
    rng = np.random.default_rng(seed)
    planes = (rng.random((p, h, w)) * 255 - 127).astype(np.float32)
    q = np.stack([jpeg_qtable(quality, 0), jpeg_qtable(quality, 1),
                  jpeg_qtable(quality, 1)] * (p // 3))
    return planes, q


def assert_core_agrees(y, c, y_ref, c_ref, q):
    jpeg8x8.check_cores(*[torch.as_tensor(np.array(a)) for a in (y, c, y_ref, c_ref, q)])


@pytest.mark.parametrize('seed,quality', [(0, 50), (1, 80), (2, 95), (3, 10)])
def test_plain_core_matches_pallas_interpret(seed, quality):
    planes, q = planes_and_tables(seed, quality=quality)
    y, c = jpeg8x8.jpeg_core_plain(torch.from_numpy(planes), torch.from_numpy(q))
    y_ref, c_ref = jax_k1.jpeg_core_pallas(jnp.asarray(planes), jnp.asarray(q), True)
    assert_core_agrees(y, c, y_ref, c_ref, q)


def test_dispatch_on_cpu_takes_the_plain_version_and_counts_no_launch():
    planes, q = planes_and_tables(4)
    before = jpeg8x8.jpeg_core_cuda.launches
    y, c = jpeg8x8.jpeg_core(torch.from_numpy(planes), torch.from_numpy(q))
    y_p, c_p = jpeg8x8.jpeg_core_plain(torch.from_numpy(planes), torch.from_numpy(q))
    assert torch.equal(y, y_p) and torch.equal(c, c_p)
    assert jpeg8x8.jpeg_core_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_shapes():
    planes, q = planes_and_tables(5)
    with pytest.raises(ValueError, match='CUDA'):
        jpeg8x8.jpeg_core_cuda(torch.from_numpy(planes), torch.from_numpy(q))
    with pytest.raises(ValueError, match='multiples of 8'):
        jpeg8x8.jpeg_core_plain(torch.zeros(3, 12, 16), torch.from_numpy(q))
    with pytest.raises(ValueError, match='q_tables'):
        jpeg8x8.jpeg_core_plain(torch.from_numpy(planes), torch.from_numpy(q[:2]))
    with pytest.raises(TypeError):
        jpeg8x8.jpeg_core_plain(torch.from_numpy(planes).double(), torch.from_numpy(q))


def test_core_backward_matches_jax_grad_through_pallas():
    planes, q = planes_and_tables(6)
    g_y = np.random.default_rng(7).standard_normal(planes.shape).astype(np.float32)
    g_c = np.random.default_rng(8).standard_normal(planes.shape).astype(np.float32)

    def loss_jax(p, qt):
        y, c = jax_k1.jpeg_core_pallas(p, qt, True)
        return jnp.sum(y * g_y) + jnp.sum(c * g_c)

    gp_ref, gq_ref = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(planes), jnp.asarray(q))
    tp = torch.from_numpy(planes).requires_grad_()
    tq = torch.from_numpy(q).requires_grad_()
    y, c = jpeg8x8.jpeg_core(tp, tq)
    (torch.sum(y * torch.from_numpy(g_y)) + torch.sum(c * torch.from_numpy(g_c))).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp_ref), atol=1e-4)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq_ref), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize('rounding', ['soft', 'sin', 'harmonic'])
@pytest.mark.parametrize('quality', [50, 80])
def test_jpeg_forward_matches_xla_form(rounding, quality):
    x = np.random.default_rng(9).random((2, 16, 24, 3)).astype(np.float32)
    ql, qc = jpeg_qtable(quality, 0), jpeg_qtable(quality, 1)
    y, coeffs = jpeg.jpeg_forward(torch.from_numpy(x), ql, qc, rounding=rounding)
    y_ref, c_ref = jax_jpeg.jpeg_forward(jnp.asarray(x), jnp.asarray(ql), jnp.asarray(qc),
                                         rounding=rounding, impl='xla')
    assert coeffs.shape == c_ref.shape
    qb = np.stack([ql, qc, qc])[None, :, None, None]
    flips = np.abs(coeffs.numpy() - np.asarray(c_ref)) > 0.5 * qb
    assert flips.sum() <= MAX_FLIP_SHARE * flips.size
    # pixels of 8x8 blocks without a flip in any channel; values in [0, 1]:
    # 1e-4 on the 255 scale is 4e-7 here, plus the color transforms' rounding
    clean = ~flips.any(axis=(1, 4, 5))                    # (N, H/8, W/8)
    clean = np.repeat(np.repeat(clean, 8, axis=1), 8, axis=2)
    np.testing.assert_allclose(y.numpy()[clean], np.asarray(y_ref)[clean], atol=2e-6)


def test_jpeg_forward_gradient_matches_jax():
    x = np.random.default_rng(10).random((2, 16, 16, 3)).astype(np.float32)
    ql, qc = jpeg_qtable(50, 0), jpeg_qtable(50, 1)
    g_ref = jax.grad(lambda v: jnp.mean((jax_jpeg.jpeg_forward(
        v, jnp.asarray(ql), jnp.asarray(qc), impl='xla')[0] - v) ** 2))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    torch.mean((jpeg.jpeg_forward(tx, ql, qc)[0] - tx) ** 2).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_ref), atol=1e-7)


@pytest.mark.parametrize('quality', [30, 50, 80])
def test_qtable_from_tensor(quality):
    for channel in (0, 1):
        t = jpeg.jpeg_qtable_traced(torch.tensor(float(quality)), channel)
        ref = jax_jpeg.jpeg_qtable_traced(jnp.float32(quality), channel)
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref))


def test_codec_wrappers_match_reference():
    x = np.random.default_rng(11).random((2, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jax_jpeg.JPEG(50, 'soft').process(jnp.asarray(x)))
    codec = jpeg.JPEG(50, 'soft', device='cpu')
    np.testing.assert_allclose(codec.process(torch.from_numpy(x)).numpy(), ref, atol=2e-6)
    ref80 = np.asarray(jax_jpeg.differentiable_jpeg(jnp.asarray(x), 80))
    np.testing.assert_allclose(jpeg.differentiable_jpeg(torch.from_numpy(x), 80).numpy(),
                               ref80, atol=2e-6)
    np.testing.assert_allclose(codec.process(torch.from_numpy(x), 80).numpy(), ref80,
                               atol=2e-6)
    dj = jpeg.DifferentiableJPEG(50, 'soft', trainable=True, device='cpu')
    assert dj.params['q_mtx_luma'].requires_grad
    with pytest.raises(ValueError):
        jpeg.JPEG(50, 'round', device='cpu')
    with pytest.raises(ValueError):
        jpeg.DifferentiableJPEG(101, device='cpu')


def test_check_cores_flags_disagreement():
    planes, q = planes_and_tables(12)
    y, c = jpeg8x8.jpeg_core_plain(torch.from_numpy(planes), torch.from_numpy(q))
    report = jpeg8x8.check_cores(y, c, y.clone(), c.clone(), torch.from_numpy(q))
    assert report['flipped'] == 0 and report['max_abs_err'] == 0
    c_bad = c.clone()
    c_bad[:, :8, :8] += torch.from_numpy(q)          # one flip per plane: 3 of 768
    with pytest.raises(AssertionError, match='disagree'):
        jpeg8x8.check_cores(y, c, y, c_bad, torch.from_numpy(q))
    with pytest.raises(AssertionError, match='disagree'):
        jpeg8x8.check_cores(y, c, y + 1e-3, c, torch.from_numpy(q))
