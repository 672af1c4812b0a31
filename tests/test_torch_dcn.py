"""Parity of the port's DCN (``models/compression.py``) with the JAX package
on the CPU: the shipped 32c codec restored in both packages, its compress /
decompress / process, and one training step with the fixed and with a
trainable codebook against the JAX ``TwitterDCN`` with
``use_pallas_quantization=True`` (its Pallas kernels in interpret mode), so
both sides run the same VJP.

Tolerances:
- latent: equal (the same codewords) at 32-64 px;
- decoded images in [0, 1]: 1e-5 (float32 convolutions summed in another
  order; measured 3.6e-7);
- entropy 1e-5 bits; the step's loss (√(2L)) 1e-5 relative; SSIM 1e-5;
- gradients, per parameter tensor, max |Δg| relative to max |g_ref|: 1e-5
  for the decoder (float32 convolutions summed in two orders; measured
  1e-6), 1e-3 for the encoder, the latent scale and the codebook, whose
  gradients pass through the quantizer's dz = (B − C·A/s)/s, a difference
  of sums that cancel near a codeword, evaluated in float32 by both
  packages (measured 4.6e-5 with the shipped codebook and 2.6e-4 with the
  off-integer trainable one, uniformly over the encoder's layers);
- Adam: the port's parameters equal those of optax ``scale_by_adam`` then
  −lr·u to 1e-6 relative on identical gradients."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.compression import codec as jcodec
from neural_imaging_tpu.models import compression as jcompression
from neural_imaging_tpu_torch.compression import codec
from neural_imaging_tpu_torch.models import base, compression

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DCN_DIR = os.path.join(ROOT, 'data/models/dcn/baselines/32c')
DECODER_GRAD_RTOL = 1e-5
ENCODER_GRAD_RTOL = 1e-3


def images(seed, n, h, w):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


def flat_numpy(params):
    return {k: np.array(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


@pytest.fixture(scope='module')
def pair():
    return jcodec.restore('32c'), codec.restore('32c', device='cpu')


def test_restore_reads_the_preset_and_its_log(pair):
    ref, port = pair
    assert port.model_code == ref.model_code
    assert port.latent_shape == ref.latent_shape == (None, None, 32)
    np.testing.assert_array_equal(port.get_codebook(), ref.get_codebook())
    assert float(port.module.latent_scale) == float(ref.params['latent_scale'])
    direct = base.restore(DCN_DIR, compression, patch_size=64, device='cpu')
    assert direct.latent_shape == (8, 8, 32) and direct.n_latent == 2048
    assert direct.compression_stats() == jcompression.TwitterDCN(
        patch_size=64, n_features=32).compression_stats()


@pytest.mark.parametrize('h,w', [(32, 32), (64, 96)])
def test_compress_decompress_process(pair, h, w):
    ref, port = pair
    x = images(h + w, 2, h, w)
    z_ref = np.asarray(ref.compress(x))
    z = port.compress(x)
    assert tuple(z.shape) == (2, h // 8, w // 8, 32)
    np.testing.assert_array_equal(z.numpy(), z_ref)
    np.testing.assert_allclose(port.decompress(z_ref).numpy(), np.asarray(ref.decompress(z_ref)),
                               atol=1e-5)
    y_ref, h_ref = ref.process(x, return_entropy=True)
    y, entropy = port.process(x, return_entropy=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    assert abs(float(entropy) - float(h_ref)) < 1e-5


def dcn_args(train_codebook):
    with open(os.path.join(DCN_DIR, 'twitterdcn', 'progress.json')) as f:
        args = dict(json.load(f)['codec']['args'])
    args['train_codebook'] = train_codebook
    return args


@pytest.mark.parametrize('train_codebook', [False, True])
def test_training_step_matches_jax(train_codebook):
    """One step at batch 2, patch 32: the fixed codebook with the shipped 32c
    weights (K2 + K3 on the card), and a trainable, off-integer codebook from
    the same weights (K2 + K4)."""
    args = dcn_args(train_codebook)
    ref = jcompression.TwitterDCN(patch_size=32, use_pallas_quantization=True, **args)
    flat = flat_numpy(ref.params)
    with np.load(os.path.join(DCN_DIR, 'twitterdcn', 'twitterdcn.npz')) as z:
        flat.update({k: z[k] for k in z.files})
    if train_codebook:
        flat['codebook'] = flat['codebook'] + 0.05
    ref.params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                              sep='/')
    port = compression.TwitterDCN(patch_size=32, device='cpu', **args)
    port.module.load_state_dict(base.convert_params(flat), strict=True)
    x = images(7, 2, 32, 32)

    def loss_of(params):
        y, entropy = ref._apply(params, jnp.asarray(x))
        return ref.loss(x, y, entropy)
    grads = base.convert_params(flat_numpy(jax.grad(loss_of)(ref.params)))
    out_ref = ref.training_step(x, learning_rate=1e-4)
    out = port.training_step(x, learning_rate=1e-4)

    assert set(out) == {'loss', 'ssim', 'entropy'}
    np.testing.assert_allclose(float(out['loss']), float(out_ref['loss']), rtol=1e-5)
    assert abs(float(out['ssim']) - float(out_ref['ssim'])) < 1e-5
    assert abs(float(out['entropy']) - float(out_ref['entropy'])) < 1e-5
    names = {name for name, _ in port.module.named_parameters()}
    assert names == set(grads)
    assert ('codebook' in names) == train_codebook
    for name, p in port.module.named_parameters():
        scale = float(grads[name].abs().max())
        assert scale > 0, name
        err = float((p.grad - grads[name]).abs().max())
        rtol = DECODER_GRAD_RTOL if name.startswith('decoder.') else ENCODER_GRAD_RTOL
        assert err <= rtol * scale, (name, err, scale)


def test_adam_matches_optax_scale_by_adam():
    """``torch.optim.Adam`` with the DCN's constants against the reference's
    optimizer, optax ``scale_by_adam`` then −lr·u, over three steps with
    gradients far from zero (Adam's first step is ≈ lr·sign(g))."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [(rng.standard_normal((4, 5)) + 2.0 * np.sign(rng.standard_normal((4, 5))))
             .astype(np.float32) for _ in range(3)]
    lrs = [1e-3, 5e-4, 1e-4]
    tx = optax.scale_by_adam()
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g, lr in zip(grads, lrs):
        u, state = tx.update(jnp.asarray(g), state, params)
        params = params - lr * u
    port = compression.TwitterDCN(patch_size=16, n_features=4, device='cpu')
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([p], **{k: port.optimizer.defaults[k]
                                   for k in ('betas', 'eps', 'weight_decay')})
    for g, lr in zip(grads, lrs):
        opt.param_groups[0]['lr'] = lr
        p.grad = torch.from_numpy(g)
        opt.step()
    assert np.abs(p.detach().numpy() - p0).min() > 1e-4
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6)


def test_trainable_codebook_moves_and_fixed_one_does_not():
    x = images(9, 2, 16, 16)
    moving = compression.TwitterDCN(patch_size=16, n_features=4, train_codebook=True,
                                    entropy_weight=50.0, device='cpu')
    fixed = compression.TwitterDCN(patch_size=16, n_features=4, device='cpu')
    before = moving.get_codebook().copy()
    for _ in range(2):
        out = moving.training_step(x, learning_rate=1e-3)
        fixed.training_step((x * 255).astype(np.uint8), learning_rate=1e-3)
    assert np.isfinite(float(out['loss']))
    assert not np.allclose(moving.get_codebook(), before)
    np.testing.assert_array_equal(fixed.get_codebook(), before)


def test_constructor_checks_its_arguments():
    with pytest.raises(ValueError, match='rounding'):
        compression.TwitterDCN(rounding='nearest', device='cpu')
    with pytest.raises(ValueError, match='latent_bpf'):
        compression.TwitterDCN(latent_bpf=9, device='cpu')
    with pytest.raises(ValueError, match='n_features'):
        compression.TwitterDCN(n_features=2, device='cpu')


def test_compare_latents_and_decodes_hold_their_bounds(pair):
    ref, port = pair
    x = images(11, 1, 64, 96)
    z = port.compress(x)
    z_ref = np.asarray(ref.compress(x))
    report = compression.compare_latents(z, z_ref, port.get_codebook())
    assert report == {'flipped': 0, 'n': z.numel(), 'share': 0.0}
    moved = z.clone().reshape(-1)
    moved[:2] += 1.0                            # 2 of 3072 indices: past the bound
    with pytest.raises(AssertionError, match='latents disagree'):
        compression.compare_latents(moved.reshape(z.shape), z_ref, port.get_codebook())
    y = port.decompress(z_ref)
    assert compression.compare_decodes(y, np.asarray(ref.decompress(z_ref))) <= 1e-5
    with pytest.raises(AssertionError, match='decoded images differ'):
        compression.compare_decodes(y + 1e-3, y)


@pytest.mark.parametrize('rounding', ['soft', 'sin', 'identity'])
def test_other_rounding_modes_take_the_plain_composition(rounding):
    """Modes other than 'soft-codebook' quantize and estimate the entropy
    with ``quantization.quantize_with_entropy`` (itself held against the JAX
    package in ``test_torch_ops`` and ``test_torch_codebook``), after the
    latent scale."""
    from neural_imaging_tpu_torch.ops import quantization
    dcn = compression.TwitterDCN(patch_size=16, n_features=4, rounding=rounding, device='cpu')
    with torch.no_grad():
        dcn.module.latent_scale.fill_(1.5)
        x = torch.from_numpy(images(13, 2, 16, 16)).permute(0, 3, 1, 2)
        z = dcn.module.encoder(x)
        q, entropy = dcn._encode(x)
        q_ref, h_ref, _ = quantization.quantize_with_entropy(
            z * 1.5, torch.from_numpy(quantization.default_codebook(5)), rounding)
    torch.testing.assert_close(q, q_ref, rtol=0, atol=0)
    torch.testing.assert_close(entropy, h_ref, rtol=0, atol=0)
