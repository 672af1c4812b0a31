"""The port's camera ISPs (UNet, DNet, ONet, ClassicISP with its
DemosaicingModule, INet under the NIPModel shell) and the weight carrier
against the JAX package's, on the CPU (their ops: test_torch_nip_ops.py).

Narrow models get the JAX package's initial weights plus numpy noise and
develop the same raw batch: forward within ``FWD_ATOL`` (float32, other
summation orders), each parameter's gradient of an L2 loss within
``GRAD_RTOL`` of its leaf's scale (the shipped snapshots and the weight
carrier: test_torch_nip_snapshots.py). The bfloat16 UNet and DNet follow flax's
rounding points, held against the flax model run op by op
(``jax.disable_jit``: jitted, XLA on the CPU keeps some bfloat16
intermediates in float32, its default excess precision): at least
``BF16_EQUAL_SHARE`` of the RGB values bit-equal and all within
``BF16_ATOL``, four bfloat16 ulps at 1 (a float32 sum that differs in its
last bit may round a bfloat16 value the other way, and the rounding carries
through the following layers; measured: DNet and the 3-level UNet
bit-equal, the 2-level UNet 99.8% and within 4.9e-4). ``NIPModel.training_step``: two
Adam steps on the same quantized batches, the losses within 1e-5
relative, and every parameter whose gradient stands above ``GRAD_RTOL`` of
its leaf's scale within ``UPDATE_ATOL`` of the reference's (Adam moves an
entry by about lr a step whatever its gradient's size, so an entry whose
gradient is rounding noise may move either way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu.ops import ops as jops
from neural_imaging_tpu_torch.models import base, pipelines
from neural_imaging_tpu_torch.ops import ops

torch.set_num_threads(1)

FWD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16_EQUAL_SHARE, BF16_ATOL = 0.99, 4 * 2.0 ** -8
LR, UPDATE_ATOL = 1e-4, 1e-6

NARROW = {
    'unet2': ('UNet', {'n_steps': 2}),
    'unet3': ('UNet', {'n_steps': 3, 'activation': 'relu'}),
    'dnet': ('DNet', {'n_layers': 2, 'n_features': 8}),
    'dnet_k5': ('DNet', {'n_layers': 3, 'n_features': 8, 'kernel': 5}),
    'classic': ('ClassicISP', {}),
    'classic_cnn': ('ClassicISP', {'c_filters': (8, 8)}),
    'classic_direct': ('ClassicISP', {'c_filters': (8,), 'residual': False}),
    'classic_str': ('ClassicISP', {'c_filters': '(8,)', 'cfa_pattern': 'rggb'}),
    'classic_percentile': ('ClassicISP', {'c_filters': (4,), 'brightness': 'percentile'}),
    'classic_shift': ('ClassicISP', {'c_filters': (4,), 'brightness': 'shift'}),
    'inet': ('INet', {'conv_precision': 'highest'}),
}


def flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


def raw_batch(seed, n=2, p=16):
    return np.random.default_rng(seed).random((n, p, p, 4)).astype(np.float32)


def model_pair(config, patch=16, seed=3):
    """The JAX model with its initial weights plus numpy noise, and the
    port's with the same weights."""
    name, kwargs = NARROW[config]
    ref = getattr(jpipelines, name)(patch_size=patch, **kwargs)
    rng = np.random.default_rng(seed)
    noisy = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in flat(ref.params).items()}
    ref.params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in noisy.items()},
                                              sep='/')
    ref.init_optimizer()
    port = getattr(pipelines, name)(patch_size=patch, device='cpu', **kwargs)
    port.module.load_state_dict(base.convert_params(noisy, base.transposed_kernels(port.module)),
                                strict=True)
    return ref, port


def port_grads(port, x, target):
    port.module.zero_grad(set_to_none=True)
    y = port._develop(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ops.mse(torch.from_numpy(target), y).backward()
    return {k: p.grad.numpy() for k, p in port.module.named_parameters()}


def ref_output_and_grads(ref, x, target):
    """The reference's RGB and gradients from one jitted program, as its
    models run (op by op, XLA splits the percentile's gradient between two
    samples one float32 ulp of their weights differently, see
    test_percentile_normalize_matches_reference)."""
    def loss(p):
        y = ref._apply(p, jnp.asarray(x))
        return jops.mse(jnp.asarray(target), y), y
    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(ref.params)
    return np.asarray(y), flat(grads)


def ref_grads(ref, x, target):
    return ref_output_and_grads(ref, x, target)[1]


def as_port_names(flat_arrays, module):
    return {k: v.numpy() for k, v in
            base.convert_params(flat_arrays, base.transposed_kernels(module)).items()}


# -- narrow models -----------------------------------------------------------------------

@pytest.mark.parametrize('config', sorted(NARROW))
def test_narrow_model_matches_reference(config):
    """Forward within FWD_ATOL and every gradient within GRAD_RTOL of its
    leaf's scale; the same parameter names and counts."""
    ref, port = model_pair(config)
    x = raw_batch(10)
    target = np.random.default_rng(11).random((2, 32, 32, 3)).astype(np.float32)
    y_ref, g_ref = ref_output_and_grads(ref, x, target)
    np.testing.assert_allclose(port.process(x).numpy(), y_ref, atol=FWD_ATOL)
    assert port.count_parameters() == ref.count_parameters()
    g = port_grads(port, x, target)
    g_ref = as_port_names(g_ref, port.module)
    assert g.keys() == g_ref.keys()
    for name, gr in g_ref.items():
        scale = np.abs(gr).max()
        if scale == 0:              # alpha without a correction CNN
            assert np.abs(g[name]).max() == 0, name
            continue
        assert np.abs(g[name] - gr).max() <= GRAD_RTOL * scale, name


@pytest.mark.parametrize('config', ['unet2', 'dnet', 'classic_cnn', 'inet'])
def test_shell_matches_reference(config):
    """Names, hyper-parameters, repr, summaries and patch shapes."""
    ref, port = model_pair(config)
    assert port.model_code == ref.model_code
    assert port.get_hyperparameters() == ref.get_hyperparameters()
    assert repr(port) == repr(ref)
    assert port.summary() == ref.summary()
    assert port.summary_compact() == ref.summary_compact()
    assert port.patch_size_raw == ref.patch_size_raw
    assert port.patch_size_rgb == ref.patch_size_rgb
    assert port.scoped_name == ref.scoped_name


def test_onet_passes_rgb_through():
    ref, port = jpipelines.ONet(patch_size=8), pipelines.ONet(patch_size=8, device='cpu')
    x = np.random.default_rng(12).random((2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(port.process(x).numpy(), np.asarray(ref.process(x)))
    assert port.count_parameters() == 0 and port.optimizer is None
    assert port.patch_size_rgb == ref.patch_size_rgb == (16, 16, 3)
    assert port.model_code == 'ONet'


def test_supported_models_match_reference():
    assert sorted(pipelines.supported_models) == sorted(jpipelines.supported_models)


@pytest.mark.parametrize('kwargs', [{'n_steps': 7}, {'activation': 'swish'}, {'dtype': 'float16'},
                                    {'loss_metric': 'L3'}])
def test_unet_refuses_bad_arguments(kwargs):
    with pytest.raises(ValueError):
        pipelines.UNet(device='cpu', **kwargs)


@pytest.mark.parametrize('name,kwargs', [('DNet', {'n_layers': 0}), ('DNet', {'kernel': 13}),
                                         ('ClassicISP', {'cfa_pattern': 'xyzw'}),
                                         ('ClassicISP', {'brightness': 'gamma'}),
                                         ('ClassicISP', {'c_filters': (0,)})])
def test_models_refuse_bad_arguments(name, kwargs):
    with pytest.raises(ValueError):
        getattr(pipelines, name)(device='cpu', **kwargs)


def test_classic_isp_camera_fingerprint_and_demosaicing():
    ref, port = model_pair('classic_cnn')
    ref.set_camera('D7000')
    port.set_camera('D7000')
    x = raw_batch(15)
    np.testing.assert_allclose(port.process(x).numpy(), np.asarray(ref.process(x)), atol=FWD_ATOL)
    srgb = np.eye(3) * 0.9
    np.testing.assert_allclose(port.process(x, cfa_pattern='bggr', srgb_mat=srgb).numpy(),
                               np.asarray(ref.process(x, cfa_pattern='bggr', srgb_mat=srgb)),
                               atol=FWD_ATOL)
    k0 = np.random.default_rng(16).standard_normal((8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(port.process_fingerprint(k0), ref.process_fingerprint(k0),
                               atol=FWD_ATOL)
    np.testing.assert_array_equal(port.process_fingerprint(k0, demosaicing=False),
                                  ref.process_fingerprint(k0, demosaicing=False))
    with pytest.raises(ValueError, match='demosaicing'):
        pipelines.UNet(n_steps=2, device='cpu').process_fingerprint(k0, cfa_pattern='gbrg')


# -- bfloat16 ----------------------------------------------------------------------------

@pytest.mark.parametrize('config', ['unet2', 'unet3', 'dnet'])
def test_bf16_models_follow_flax_rounding(config):
    name, kwargs = NARROW[config]
    _, port32 = model_pair(config)
    ref = getattr(jpipelines, name)(patch_size=16, dtype='bfloat16', **kwargs)
    port = getattr(pipelines, name)(patch_size=16, dtype='bfloat16', device='cpu', **kwargs)
    port.module.load_state_dict(port32.module.state_dict())
    ref.params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in port.checkpoint().items()}, sep='/')
    x = raw_batch(17)
    got = port.process(x).numpy()
    with jax.disable_jit():
        expected = np.asarray(ref._apply(ref.params, jnp.asarray(x)))
    assert np.mean(got == expected) >= BF16_EQUAL_SHARE
    np.testing.assert_allclose(got, expected, atol=BF16_ATOL)


# -- the training step -----------------------------------------------------------------

def camera_batches(seed, n=2, p=16):
    pairs = [fixtures.make_raw_rgb_pair(2 * p, 2 * p, seed=seed + i) for i in range(n)]
    return np.stack([q[0] for q in pairs]), np.stack([q[1] for q in pairs])


@pytest.mark.parametrize('config', ['unet2', 'dnet', 'classic_cnn', 'inet'])
def test_two_training_steps_match_reference(config):
    ref, port = model_pair(config)
    initial = {k: p.detach().clone().numpy() for k, p in port.module.named_parameters()}
    for step, seed in enumerate((22, 24)):
        bx, by = camera_batches(seed)
        x = jops.normalize_batch(jnp.asarray(bx))
        y = jops.normalize_batch(jnp.asarray(by))
        g_ref = as_port_names(ref_grads(ref, np.asarray(x), np.asarray(y)), port.module)
        loss_ref = float(ref.training_step(bx, by, LR))
        loss = port.training_step(bx, by, LR)
        assert loss.shape == () and loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5, err_msg=f'step {step}')
    ref_after = as_port_names(flat(ref.params), port.module)
    for name, p in port.module.named_parameters():
        moved = p.detach().numpy() - initial[name]
        moved_ref = ref_after[name] - initial[name]
        steady = np.abs(g_ref[name]) > GRAD_RTOL * np.abs(g_ref[name]).max()
        assert np.abs(moved_ref).max() > 0, name
        np.testing.assert_allclose(moved[steady], moved_ref[steady], atol=UPDATE_ATOL,
                                   err_msg=name)
