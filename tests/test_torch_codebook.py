"""Parity of the port's soft-codebook quantizer with the JAX package on the
CPU: the plain versions of K2, K3 and K4 against the Pallas kernels of
``ops/pallas/codebook.py`` run in interpret mode (as
``tests/test_pallas.py::TestCodebookKernel`` runs them), the fused entry
point and its two VJPs against the JAX fused entry point, and the port's
plain composition against ``ops/quantization.py``.

Tolerances (float32 on both sides, sums over the L codewords in the same
order, but log1p, exp and the final sums from different libraries):
- hard indices and the straight-through values: equal;
- soft values: 1e-5 (codewords up to 16 in magnitude, a few float32 ulps);
- entropy 1e-5 bits and histogram 1e-6, as the JAX tests hold them;
- the kernels' dz and dcb for arbitrary cotangents: ``cb.check_backward``,
  32 float32 epsilons of the float64 magnitude of the terms each entry sums
  (dz is a difference of sums that cancel near a codeword, so a fixed atol
  would be either loose or wrong);
- gradients of the fused entry points for a loss like the DCN's: 2e-5
  absolute, for gradients of order 1 (the JAX tests hold the fused VJP to
  XLA autodiff at 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import check_division
from neural_imaging_tpu.ops import quantization as jquant
from neural_imaging_tpu.ops.pallas import codebook as jcb
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.ops.hopper import codebook as cb

torch.set_num_threads(1)

SOFT_ATOL = 1e-5
GRAD_ATOL = 2e-5
KERNELS = [(50.0, 25.0), (0.0, 5.0)]      # t-Student (the DCN's) and Gaussian


def latent(seed, shape, scale):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


# (shape, bpf, scale): a tile-aligned 4-D latent and an unaligned flat one
CASES = [((4, 8, 8, 3), 5, 6.0), ((777,), 4, 4.0)]


def codeword_cotangent(seed, n_codes):
    return np.random.default_rng(seed).standard_normal(n_codes).astype(np.float32)


@pytest.mark.parametrize('v,gamma', KERNELS)
@pytest.mark.parametrize('shape,bpf,scale', CASES)
def test_plain_k2_matches_pallas(shape, bpf, scale, v, gamma):
    z = latent(0, shape, scale).reshape(-1)
    codebook = jquant.default_codebook(bpf)
    soft_ref, hard_ref, counts_ref = jcb._pallas_forward(jnp.asarray(z), codebook, v, gamma,
                                                         True)
    soft, hard = cb.codebook_fwd_plain(torch.from_numpy(z), torch.from_numpy(codebook), v, gamma)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hard_ref))
    np.testing.assert_allclose(soft.numpy(), np.asarray(soft_ref), atol=SOFT_ATOL)
    counts = torch.bincount(hard, minlength=codebook.size)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_ref))


@pytest.mark.parametrize('v,gamma', KERNELS)
@pytest.mark.parametrize('shape,bpf,scale', CASES)
def test_plain_k3_matches_pallas(shape, bpf, scale, v, gamma):
    z = latent(1, shape, scale).reshape(-1)
    g = latent(2, z.shape, 1.0)
    codebook = jquant.default_codebook(bpf)
    pc = codeword_cotangent(3, codebook.size)
    dz_ref = jcb._pallas_backward(jnp.asarray(z), jnp.asarray(g), jnp.asarray(pc), codebook,
                                  v, gamma, True)
    args = tuple(map(torch.from_numpy, (z, g, codebook, pc)))
    dz = cb.codebook_bwd_plain(*args, v, gamma)
    dz_scale, _ = cb.backward_error_scale(*args, v, gamma)
    cb.check_backward(dz, torch.tensor(np.asarray(dz_ref)), dz_scale)


@pytest.mark.parametrize('v,gamma', KERNELS)
@pytest.mark.parametrize('shape,bpf,scale', CASES)
def test_plain_k4_matches_pallas(shape, bpf, scale, v, gamma):
    z = latent(4, shape, scale).reshape(-1)
    g = latent(5, z.shape, 1.0)
    codebook = jquant.default_codebook(bpf) + 0.05
    pc = codeword_cotangent(6, codebook.size)
    dz_ref, dcb_ref = jcb._pallas_backward_trainable(
        jnp.asarray(z), jnp.asarray(g), jnp.asarray(pc), jnp.asarray(codebook), v, gamma, True)
    args = tuple(map(torch.from_numpy, (z, g, codebook, pc)))
    dz, dcb = cb.codebook_bwd_train_plain(*args, v, gamma)
    dz_scale, dcb_scale = cb.backward_error_scale(*args, v, gamma)
    cb.check_backward(dz, torch.tensor(np.asarray(dz_ref)), dz_scale)
    cb.check_backward(dcb, torch.tensor(np.asarray(dcb_ref)), dcb_scale, 'dcb')


@pytest.mark.parametrize('v,gamma', KERNELS)
@pytest.mark.parametrize('shape,bpf,scale', CASES)
def test_fused_forward_matches_jax_fused(shape, bpf, scale, v, gamma):
    z = latent(7, shape, scale)
    codebook = jquant.default_codebook(bpf)
    q_ref, h_ref, hist_ref = jcb.quantize_with_entropy_pallas(jnp.asarray(z), codebook, v, gamma)
    q, h, hist = cb.quantize_with_entropy_fused(torch.from_numpy(z),
                                                torch.from_numpy(codebook), v, gamma)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert abs(float(h) - float(h_ref)) < 1e-5
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_ref), atol=1e-6)


def objective(q, h):
    return 0.001 * (q ** 2).sum() + 10.0 * h


@pytest.mark.parametrize('v,gamma', KERNELS)
@pytest.mark.parametrize('shape,bpf,scale', CASES)
def test_fixed_codebook_gradient_matches_jax_fused(shape, bpf, scale, v, gamma):
    z = latent(8, shape, scale)
    codebook = jquant.default_codebook(bpf)
    g_ref = jax.grad(lambda x: objective(
        *jcb.quantize_with_entropy_pallas(x, codebook, v, gamma)[:2]))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    objective(*cb.quantize_with_entropy_fused(zt, torch.from_numpy(codebook), v,
                                              gamma)[:2]).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_ref), atol=GRAD_ATOL)


@pytest.mark.parametrize('v,gamma', KERNELS)
def test_trainable_codebook_gradients_match_jax_fused(v, gamma):
    z = latent(9, (4, 8, 8, 3), 6.0)
    codebook = jquant.default_codebook(5) + 0.05     # off-integer: nontrivial dcb
    gz_ref, gc_ref = jax.grad(lambda x, c: objective(
        *jcb.quantize_with_entropy_pallas(x, c, v, gamma, trainable=True)[:2]),
        argnums=(0, 1))(jnp.asarray(z), jnp.asarray(codebook))
    zt = torch.from_numpy(z).requires_grad_()
    ct = torch.from_numpy(codebook.copy()).requires_grad_()
    q, h, hist = cb.quantize_with_entropy_fused(zt, ct, v, gamma, trainable=True)
    q_ref, h_ref, _ = jquant.quantize_with_entropy(jnp.asarray(z), jnp.asarray(codebook),
                                                   'soft-codebook', v, gamma)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_ref), atol=1e-6)
    assert abs(float(h.detach()) - float(h_ref)) < 1e-5
    objective(q, h).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz_ref), atol=GRAD_ATOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc_ref), atol=GRAD_ATOL)


@pytest.mark.parametrize('v,gamma', [(50.0, 25.0), (7.5, 25.0), (0.0, 5.0)])
def test_plain_composition_matches_jax(v, gamma):
    """The port's (N, L) composition, including the integer-ν rsqrt path
    (ν = 50) and the log-space softmax (ν = 7.5, Gaussian), values and
    autograd gradients."""
    z = latent(10, (2, 4, 4, 8), 6.0)
    codebook = jquant.default_codebook(5)
    q_ref, h_ref, hist_ref = jquant.quantize_with_entropy(jnp.asarray(z), codebook,
                                                          'soft-codebook', v, gamma)
    g_ref = jax.grad(lambda x: objective(*jquant.quantize_with_entropy(
        x, codebook, 'soft-codebook', v, gamma)[:2]))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    q, h, hist = quant.quantize_with_entropy(zt, codebook, 'soft-codebook', v, gamma)
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(q_ref))
    assert abs(float(h) - float(h_ref)) < 1e-5
    np.testing.assert_allclose(hist.detach().numpy(), np.asarray(hist_ref), atol=1e-6)
    objective(q, h).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_ref), atol=GRAD_ATOL)


def near_tie_values(codebook, seed):
    """Values where two log-weights tie or nearly tie: every codeword, the
    midpoint of every pair of neighbours and 1 and 2 float32 ulps on either
    side of it, values far outside the codebook, and random ones."""
    sorted_cb = np.unique(codebook.astype(np.float32))
    mid = ((sorted_cb[:-1].astype(np.float64) + sorted_cb[1:]) / 2).astype(np.float32)
    up, down = np.nextafter(mid, np.float32(np.inf)), np.nextafter(mid, np.float32(-np.inf))
    rng = np.random.default_rng(seed)
    return np.concatenate([
        sorted_cb, mid, up, down, np.nextafter(up, np.float32(np.inf)),
        np.nextafter(down, np.float32(-np.inf)), np.float32([-1e3, -40.0, 40.0, 1e3]),
        (rng.standard_normal(500) * 8).astype(np.float32)]).astype(np.float32)


def trainable_style_codebook(kind, seed):
    """The 5-bpf codebook as a trainable one may leave it: in order, shuffled
    and moved off the integers, or with repeated codewords."""
    codebook = quant.default_codebook(5)
    rng = np.random.default_rng(seed)
    if kind == 'unsorted':
        codebook = rng.permutation(codebook) + rng.uniform(-0.3, 0.3, codebook.size)
    elif kind == 'repeated':
        codebook = rng.permutation(np.concatenate([codebook[:24], codebook[4:12]]))
    return codebook.astype(np.float32)


@pytest.mark.parametrize('v,gamma', KERNELS)
@pytest.mark.parametrize('kind', ['sorted', 'unsorted', 'repeated'])
def test_nearest_codeword_argmax_is_the_first_argmax(kind, v, gamma):
    """K2's, K3's and K4's max rule (nearest codeword, then the first j with
    logw_j == m) gives the max and the first argmax of the two-pass rule,
    bit for bit, at exact and near ties."""
    codebook = torch.from_numpy(trainable_style_codebook(kind, 14))
    z = torch.from_numpy(near_tie_values(codebook.numpy(), 15))
    m_ref, best_ref = cb._argmax_pass(z, codebook, v, gamma, cb._scalar(v, z))
    m, best, slow = cb.nearest_argmax_plain(z, codebook, v, gamma)
    assert torch.equal(best, best_ref)
    assert torch.equal(m, m_ref)
    # the one-pass rule decides all but a few values (none on this CPU)
    assert int(slow.sum()) <= 2


def test_division_by_v_through_its_reciprocal_is_the_ieee_quotient():
    """K2's, K3's and K4's t / v at L = 32 (two FMAs from 1/v) has the IEEE
    quotient's bits, sampled over the t and v where they use it
    (``check_division.py`` checks every t)."""
    mismatches, checked = check_division.check(sample=200_000, seed=16)
    assert checked == 200_000 and mismatches == dict.fromkeys(check_division.V_VALUES, 0)


def test_codebook_weights_match_jax():
    x = latent(11, (64,), 6.0)
    codebook = jquant.default_codebook(5)
    for v, gamma in ((50.0, 25.0), (7.5, 25.0), (0.0, 5.0)):
        ref = jquant.codebook_weights(jnp.asarray(x), jnp.asarray(codebook), v, gamma)
        w = quant.codebook_weights(torch.from_numpy(x), torch.from_numpy(codebook), v, gamma)
        np.testing.assert_allclose(w.numpy(), np.asarray(ref), atol=1e-6)


def test_fused_matches_the_plain_composition():
    z = torch.from_numpy(latent(12, (2, 8, 8, 4), 6.0))
    codebook = torch.from_numpy(quant.default_codebook(5))
    q, h, hist = cb.quantize_with_entropy_fused(z, codebook)
    q_ref, h_ref, hist_ref = quant.quantize_with_entropy(z, codebook)
    torch.testing.assert_close(q, q_ref, rtol=0, atol=0)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(hist, hist_ref, rtol=0, atol=1e-6)


def test_dispatch_on_cpu_takes_the_plain_versions_and_counts_no_launch():
    z = torch.from_numpy(latent(13, (300,), 6.0)).requires_grad_()
    codebook = torch.from_numpy(quant.default_codebook(5) + 0.05).requires_grad_()
    counters = (cb.codebook_fwd_cuda, cb.codebook_bwd_cuda, cb.codebook_bwd_train_cuda)
    before = [f.launches for f in counters]
    for trainable in (False, True):
        q, h, _ = cb.quantize_with_entropy_fused(z, codebook, trainable=trainable)
        objective(q, h).backward()
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize('wrapper,n_args', [(cb.codebook_fwd_cuda, 2), (cb.codebook_bwd_cuda, 4),
                                            (cb.codebook_bwd_train_cuda, 4)])
def test_cuda_wrappers_refuse_cpu_tensors_and_bad_inputs(wrapper, n_args):
    z = torch.zeros(8)
    codebook = torch.arange(4.0)
    args = (z, codebook, torch.zeros(8), torch.zeros(4))
    order = (0, 2, 1, 3) if n_args == 4 else (0, 1)
    call = [args[i] for i in order]
    with pytest.raises(ValueError, match='CUDA'):
        wrapper(*call)
    with pytest.raises(TypeError, match='float32'):
        wrapper(*[t.double() for t in call])
    with pytest.raises(ValueError, match='entries'):
        wrapper(*[torch.zeros(257) if t is codebook else t for t in call])
