"""Parity of the port's models (INet, the FAN, checkpoint conversion) with the
JAX package on the CPU, from shipped weights and from JAX-initialized ones
carried over with ``convert_params``.

Tolerances: INet's RGB in [0, 1] agrees to 1e-5 (float32 convs summed in
another order). FAN probabilities agree to 1e-5, and their logarithms to 1e-3
wherever the probability exceeds 1e-20, so saturated rows are held too."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.models import forensics as jforensics
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu_torch.models import base, forensics, pipelines

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INET_DIR = os.path.join(ROOT, 'data/models/nip/QualityRef/INet_gbrg_5x5/inet')
RUN_DIR = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')


def raw_batch(seed, n=2, p=16):
    return np.random.default_rng(seed).random((n, p, p, 4)).astype(np.float32)


def rgb_batch(n=2, p=16):
    return np.stack([fixtures.procedural_image(p, p, seed=s) for s in range(n)]
                    ).astype(np.float32)


def flat_params(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


def assert_probabilities_agree(p, p_ref):
    p, p_ref = np.asarray(p), np.asarray(p_ref)
    np.testing.assert_allclose(p, p_ref, atol=1e-5)
    keep = p_ref > 1e-20
    np.testing.assert_allclose(np.log(p[keep]), np.log(p_ref[keep]), atol=1e-3)


def test_convert_params_layouts():
    flat = {'conv0/kernel': np.zeros((5, 5, 3, 8), np.float32),
            'conv0/bias': np.zeros(8, np.float32),
            'head/kernel': np.zeros((16, 4), np.float32),
            'demosaic': np.zeros((5, 5, 3, 3), np.float32)}
    state = base.convert_params(flat)
    assert state['conv0.weight'].shape == (8, 3, 5, 5)
    assert state['conv0.bias'].shape == (8,)
    assert state['head.weight'].shape == (4, 16)
    assert state['demosaic'].shape == (3, 3, 5, 5)
    w = np.arange(5 * 5 * 3 * 8, dtype=np.float32).reshape(5, 5, 3, 8)
    assert float(base.convert_params({'k': w})['k'][7, 2, 4, 1]) == w[4, 1, 2, 7]


@pytest.mark.parametrize('patch', [16, 32])
def test_inet_shipped_weights(patch):
    ref = jpipelines.INet(patch_size=patch, conv_precision='highest')
    ref.load_model(INET_DIR)
    port = pipelines.INet(patch_size=patch, conv_precision='highest', device='cpu')
    port.load_model(INET_DIR)
    x = raw_batch(patch)
    np.testing.assert_allclose(port.process(x).numpy(), np.asarray(ref.process(x)), atol=1e-5)


@pytest.mark.parametrize('kwargs', [{}, {'random_init': True}, {'kernel': 3},
                                    {'cfa_pattern': 'rggb'}])
def test_inet_initial_weights(kwargs):
    ref = jpipelines.INet(patch_size=16, **kwargs)
    port = pipelines.INet(patch_size=16, device='cpu', **kwargs)
    x = raw_batch(1)
    np.testing.assert_allclose(port.process(x).numpy(), np.asarray(ref.process(x)), atol=1e-5)


def test_inet_refuses_bf16_precisions():
    """INet's bfloat16 precision 'default' (operands rounded to bfloat16,
    float32 sums) builds and holds against the JAX INet at 'default' (float32
    on the CPU) within the operand rounding: 8 · 2^-8 in the max, 2^-9 in the
    mean (tests/test_torch_precision.py says why); a precision that is not
    the reference's is refused."""
    ref = jpipelines.INet(patch_size=16, conv_precision='default')
    ref.load_model(INET_DIR)
    port = pipelines.INet(patch_size=16, conv_precision='default', device='cpu')
    port.load_model(INET_DIR)
    x = raw_batch(16)
    diff = np.abs(port.process(x).numpy() - np.asarray(ref.process(x)))
    assert diff.max() <= 8 * 2 ** -8 and diff.mean() <= 2 ** -9
    with pytest.raises(ValueError, match='conv precision'):
        pipelines.INet(conv_precision='bfloat16', device='cpu')


def test_constrained_conv_kernel_and_output():
    ref = jforensics.ConstrainedConv()
    x = rgb_batch()
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.random.default_rng(2).standard_normal((5, 5, 3, 3)).astype(np.float32)
    variables = {'params': {'kernel': jnp.asarray(kernel)}}
    port = forensics.ConstrainedConv()
    port.load_state_dict(base.convert_params({'kernel': kernel}))
    nf_ref = np.asarray(ref.apply(variables, jnp.asarray(x), kernel_only=True))
    np.testing.assert_allclose(port.normalized_kernel().detach().permute(2, 3, 1, 0).numpy(),
                               nf_ref, rtol=1e-5, atol=1e-4)
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.apply(variables, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize('kwargs', [
    {'n_filters': 4, 'n_convolutions': 2},
    {'n_filters': 4, 'n_convolutions': 2, 'use_gap': False, 'n_dense': 1},
    {'n_filters': 4, 'n_convolutions': 3, 'kernel': 3, 'n_fscale': 1.5},
    {'n_filters': 4, 'n_convolutions': 2, 'activation': 'relu'},
])
def test_narrow_fan_with_reference_init(kwargs):
    ref = jforensics.FAN(n_classes=5, patch_size=16, **kwargs)
    port = forensics.FAN(n_classes=5, patch_size=16, device='cpu', **kwargs)
    port.module.load_state_dict(base.convert_params(flat_params(ref.params)), strict=True)
    x = rgb_batch()
    assert_probabilities_agree(port.process(x).numpy(), ref.process(x))


def test_shipped_fan_on_16px_input():
    ref = jforensics.FAN(n_classes=5, patch_size=16)
    ref.load_model(os.path.join(RUN_DIR, 'models/fan'))
    port = forensics.FAN(n_classes=5, patch_size=16, device='cpu')
    port.load_model(os.path.join(RUN_DIR, 'models/fan'))
    assert port.count_parameters() == 1_145_382
    x = rgb_batch(3)
    assert_probabilities_agree(port.process(x).numpy(), ref.process(x))


def test_fan_refuses_unported_variants():
    """The bfloat16 FAN and the fused stem build (tests/test_torch_precision.py
    holds them against the reference); a dtype or stem the reference does not
    have is refused, and so is a fused stem without a conv to fuse."""
    fan = forensics.FAN(n_classes=5, dtype='bfloat16', stem='fused', device='cpu')
    assert fan.module.compute_dtype == torch.bfloat16 and fan.module.stem == 'fused'
    with pytest.raises(ValueError, match='dtype'):
        forensics.FAN(n_classes=5, dtype='float16', device='cpu')
    with pytest.raises(ValueError, match='stem'):
        forensics.FAN(n_classes=5, stem='merged', device='cpu')
    with pytest.raises(ValueError, match='n_convolutions'):
        forensics.FAN(n_classes=5, n_convolutions=0, stem='fused', device='cpu')


def test_fan_random_init_is_seeded():
    a = forensics.FAN(n_classes=3, patch_size=16, n_filters=4, n_convolutions=2, device='cpu')
    b = forensics.FAN(n_classes=3, patch_size=16, n_filters=4, n_convolutions=2, device='cpu')
    c = forensics.FAN(n_classes=3, patch_size=16, n_filters=4, n_convolutions=2, seed=1,
                      device='cpu')
    assert torch.equal(a.module.conv0.weight, b.module.conv0.weight)
    assert not torch.equal(a.module.conv0.weight, c.module.conv0.weight)


def test_crossentropy():
    p = np.random.default_rng(4).dirichlet(np.ones(5), size=8).astype(np.float32)
    p[0] = [1, 0, 0, 0, 0]
    labels = np.arange(8) % 5
    ref = jforensics.sparse_categorical_crossentropy(jnp.asarray(labels), jnp.asarray(p))
    out = forensics.sparse_categorical_crossentropy(torch.from_numpy(labels), torch.from_numpy(p))
    assert float(out) == pytest.approx(float(ref), rel=1e-6)
