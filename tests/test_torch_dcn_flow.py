"""The joint flow with a learned codec as its channel (ONet → sharpen:1 /
jpeg:80 → TwitterDCN 32c → FAN, downsampling 'none', the shape of the
``m_quality_dcn`` runs) in the PyTorch port against the JAX package's, on
the CPU at raw patch 16 (RGB 32), batch 2, with the framework scenario's
narrow FAN ({'n_convolutions': 2, 'n_filters': 16, 'n_dense': 1}) whose
weights are drawn with numpy and given to both, and the shipped 32c codec.
The reference's codec runs with ``use_pallas_quantization=True`` (its
Pallas kernels in interpret mode), so both packages differentiate the
quantizer with the same VJP: on the CPU its 'auto' policy would autodiff
the plain composition, whose histogram clip and normalization the Pallas
VJP (and the port's K3/K4) treat as the identity.

Tolerances:
- probabilities: ``compare_probabilities``; the channel's output in [0, 1]
  within 1e-5 (float32 convolutions summed in another order);
- the loss and its parts ('ce', 'dcn'): 1e-5 relative;
- gradients, per parameter tensor, max |Δg| relative to max |g_ref|: the
  bounds of ``tests/test_torch_dcn.py`` for the codec, 1e-5 for its decoder
  (float32 convolutions summed in two orders) and 1e-3 for the encoder and
  the latent scale, whose gradients pass through the quantizer's
  dz = (B − C·A/s)/s, a difference of sums that cancel near a codeword; for
  the FAN the bound ``tests/test_torch_train_step.py`` gives it, 1e-4: its
  input, the codec's decode, agrees to the decode bound (1e-5), not to a
  float32 rounding (measured 1.4e-5 on conv0);
- one Adam step: each parameter within 2·lr + 1e-6 of the reference's, and
  within 1e-6 where its gradient is above 1e-3 of its leaf's scale (Adam's
  first step is lr·sign(g), so an entry whose gradient is rounding noise
  may move the other way)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import test_fan
from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.workflows import ManipulationClassification as JaxFlow
from neural_imaging_tpu_torch.models import base
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification, compare_probabilities)

torch.set_num_threads(1)

PATCH, BATCH = 16, 2
MANIPULATIONS = ['sharpen:1', 'jpeg:80']
FAN_ARGS = {'n_convolutions': 2, 'n_filters': 16, 'n_dense': 1}
DISTRIBUTION = {'downsampling': 'none', 'compression': 'dcn',
                'compression_params': {'dirname': '32c'}}
LAMBDA_DCN, LR = 0.1, 1e-4
TIGHT_RTOL, QUANTIZER_RTOL, FAN_RTOL = 1e-5, 1e-3, 1e-4
UPDATE_ATOL = 1e-6


def flat_params(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


def fan_weights(reference, seed=11):
    """numpy-drawn weights for the narrow FAN, as flax paths: the constrained
    filter's initial value plus noise, LeCun-scaled kernels, small biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(flat_params(reference).items()):
        if k.startswith('constrained'):
            w = v + 0.1 * rng.standard_normal(v.shape)
        elif k.endswith('kernel'):
            w = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            w = 0.01 * rng.standard_normal(v.shape)
        out[k] = w.astype(np.float32)
    return out


def make_flows(trainable):
    """The JAX flow (its codec on the Pallas VJP) and the port's, with the
    same FAN weights and the shipped 32c codec."""
    ref = JaxFlow('ONet', manipulations=MANIPULATIONS, distribution=DISTRIBUTION,
                  fan_args=FAN_ARGS, trainable=trainable, raw_patch_size=PATCH)
    ref.codec.use_pallas_quantization = True
    weights = fan_weights(ref.fan.params)
    ref.fan.params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in weights.items()}, sep='/')
    ref.params = ref._collect_params()
    ref.opt_state = ref._tx.init(ref._train_partition(ref.params))
    port = ManipulationClassification('ONet', manipulations=MANIPULATIONS,
                                      distribution=DISTRIBUTION, fan_args=FAN_ARGS,
                                      trainable=trainable, raw_patch_size=PATCH, device='cpu')
    port.fan.module.load_state_dict(base.convert_params(weights), strict=True)
    port._snapshot()
    port.reinitialize()
    return ref, port


@pytest.fixture(scope='module')
def joint():
    return make_flows({'dcn', 'fan'})


@pytest.fixture(scope='module')
def frozen():
    return make_flows(set())


def rgb_batch(seed):
    """Procedural RGB patches (the input of ONet), float32 in [0, 1]."""
    return np.stack([fixtures.procedural_image(2 * PATCH, 2 * PATCH, seed=seed + i)
                     for i in range(BATCH)]).astype(np.float32)


def reference_step(ref, x):
    """The reference's loss, its parts and its gradients over the trainable
    partition, as {part: {port name: array}}."""
    if 'grads' not in ref._jitted:
        def loss_of(tparams, fparams, x):
            q = jnp.ones((8, 8), jnp.float32)
            return ref._losses({**fparams, **tparams}, x, x, jax.random.PRNGKey(0), q, q,
                               0.0, LAMBDA_DCN)
        ref._jitted['grads'] = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    (loss, parts), grads = ref._jitted['grads'](ref._train_partition(ref.params),
                                                 ref._frozen_partition(ref.params),
                                                 jnp.asarray(x))
    grads = {part: {k: v.numpy() for k, v in base.convert_params(flat_params(g)).items()}
             for part, g in grads.items()}
    return float(loss), {k: float(v) for k, v in parts.items()}, grads


def rtol_of(part, name):
    if part == 'fan':
        return FAN_RTOL
    return TIGHT_RTOL if name.startswith('decoder.') else QUANTIZER_RTOL


def assert_step_matches(ref, port, x):
    ref_loss, ref_parts, ref_grads = reference_step(ref, x)
    loss, parts, grads = port.loss_and_gradients(x, x, 0.0, LAMBDA_DCN)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=TIGHT_RTOL)
    for name in ('ce', 'dcn'):
        np.testing.assert_allclose(float(parts[name]), ref_parts[name], rtol=TIGHT_RTOL,
                                   err_msg=name)
    assert grads.keys() == ref_grads.keys()
    for part, leaves in ref_grads.items():
        assert leaves.keys() == grads[part].keys(), part
        for name, g_ref in leaves.items():
            scale = np.abs(g_ref).max()
            assert scale > 0, f'{part}/{name}: no gradient'
            err = np.abs(grads[part][name].numpy() - g_ref).max()
            assert err <= rtol_of(part, name) * scale, f'{part}/{name}: {err} vs {scale}'
    return grads


def test_probabilities_and_channel_match_reference(joint):
    ref, port = joint
    x = rgb_batch(5)
    out_ref = ref.run_workflow(x)
    out = port.run_workflow(x)
    for got, expected in zip(out[:3], out_ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5)
    np.testing.assert_allclose(float(out[3]), float(out_ref[3]), rtol=TIGHT_RTOL)
    report = compare_probabilities(out[4], np.asarray(out_ref[4]))
    assert report['rows'] == BATCH * port.n_classes == 6


def test_joint_step_gradients_match_reference(joint):
    """The loss parts and every trainable leaf's gradient: the codec's 37
    leaves (encoder, decoder, latent scale) and the FAN's."""
    ref, port = joint
    grads = assert_step_matches(ref, port, rgb_batch(20))
    assert len(grads['dcn']) == 37 and set(grads) == {'dcn', 'fan'}


def test_joint_adam_step_matches_reference(joint):
    ref, port = joint
    x = rgb_batch(30)
    _, _, ref_grads = reference_step(ref, x)
    before = {part: {k: p.detach().numpy().copy() for k, p in leaves.items()}
              for part, leaves in port._collect_params().items()}
    ref_loss, ref_parts = ref.training_step(x, x, 0.0, LAMBDA_DCN, learning_rate=LR)
    loss, parts = port.training_step(x, x, 0.0, LAMBDA_DCN, learning_rate=LR)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TIGHT_RTOL)
    after_ref = {part: base.convert_params(flat_params(ref.params[part]))
                 for part in ('dcn', 'fan')}
    for part, leaves in port._train_partition(port._collect_params()).items():
        for name, p in leaves.items():
            p, p0, p_ref = p.detach().numpy(), before[part][name], after_ref[part][name].numpy()
            diff = np.abs(p - p_ref)
            assert diff.max() <= 2 * LR + UPDATE_ATOL, f'{part}/{name}'
            g = ref_grads[part][name]
            clear = np.abs(g) > 1e-3 * np.abs(g).max()
            assert diff[clear].max(initial=0) <= UPDATE_ATOL, f'{part}/{name}'
            assert np.abs(p - p0).max() > 0.5 * LR, f'{part}/{name} did not move'


def test_frozen_codec_step_matches_reference(frozen):
    """The run's ``fixed-codec`` sibling: only the FAN trains; the codec's
    parameters stay out of the optimizer and do not move."""
    ref, port = frozen
    grads = assert_step_matches(ref, port, rgb_batch(40))
    assert set(grads) == {'fan'}
    codec_before = {k: p.detach().clone() for k, p in port.codec.module.named_parameters()}
    port.training_step(rgb_batch(41), None, 0.0, LAMBDA_DCN, learning_rate=LR)
    for k, p in port.codec.module.named_parameters():
        assert torch.equal(p, codec_before[k]), k


def test_flow_is_built_as_the_reference_builds_it(joint):
    ref, port = joint
    assert port.summary() == ref.summary()
    assert port.codec.summary() == ref.codec.summary()
    assert port.codec.summary() == ('TwitterDCN : 4x4x32-D latent space @ 5-bpf '
                                    '[2,533,293 params]')
    assert repr(port.codec) == repr(ref.codec) == 'TwitterDCN(rounding=soft-codebook)'
    assert port.codec.get_hyperparameters() == ref.codec.get_hyperparameters()
    assert port.fan.patch_size == port.codec.patch_size == 2 * PATCH


def test_restore_builds_a_run_with_a_dcn_channel(tmp_path, joint):
    """A run directory whose channel is the learned codec: ``training.json``
    with the ``m_quality_dcn`` run's distribution and the FAN's npz. Both
    packages rebuild the codec from the logged directory (the reference's
    ``test_fan.py`` does not read a snapshot of a trained codec) and classify
    alike."""
    _, port = joint
    run = tmp_path / 'run'
    port.fan.save_model(str(run / 'models' / 'fan'))
    with open(os.path.join(os.path.dirname(__file__), '..', 'data/m_quality_dcn/QualityRef/'
                           'ONet/fixed-nip/lc-0.1000/000/training.json')) as f:
        log = json.load(f)
    log['manipulations'] = ['native'] + MANIPULATIONS
    log['forensics']['args'] = {**log['forensics']['args'], **FAN_ARGS, 'n_classes': 3}
    with open(run / 'training.json', 'w') as f:
        json.dump(log, f)
    restored = ManipulationClassification.restore(str(run), PATCH, device='cpu')
    assert restored._distribution['compression'] == 'dcn'
    assert restored.codec.latent_shape == (4, 4, 32)
    args = type('Args', (), {k: None for k in ('jpeg', 'codec', 'dcn', 'ds', 'manip',
                                               'channel_dtype', 'channel_jpeg_dtype',
                                               'manip_jpeg_dtype')})()
    args.patch = PATCH
    ref, _ = test_fan.restore_flow(str(run / 'training.json'), args)
    x = rgb_batch(50)
    compare_probabilities(restored.run_workflow(x)[-1], np.asarray(ref.run_workflow(x)[-1]))


@pytest.mark.parametrize('kwargs, error', [
    ({'manipulations': ['awgn']}, NotImplementedError),
    ({'distribution': {**DISTRIBUTION, 'compression': 'bpg'}}, ValueError),
    ({'trainable': {'nip'}}, ValueError),
], ids=['manipulation', 'compression', 'onet-trainable'])
def test_refusals_that_remain(kwargs, error):
    """An unported manipulation names its ROADMAP item; an unknown channel
    is refused by both packages, and so is a trainable ONet (it has no
    parameters) once the trainer checks it."""
    args = {'manipulations': MANIPULATIONS, 'distribution': DISTRIBUTION,
            'fan_args': FAN_ARGS, 'raw_patch_size': PATCH, **kwargs}
    if error is NotImplementedError:
        with pytest.raises(error, match='item 2'):
            ManipulationClassification('ONet', device='cpu', **args)
        return
    if 'trainable' in kwargs:
        from neural_imaging_tpu_torch.training.manipulation import train_manipulation_nip
        flow = ManipulationClassification('ONet', device='cpu', **args)
        with pytest.raises(ValueError, match='no trainable parameters'):
            train_manipulation_nip(flow, {'camera_name': 'x', 'patch_size': PATCH,
                                          'batch_size': 1}, FakeRGBData(),
                                   directories={'root': '/nonexistent-run-root'})
        return
    with pytest.raises(error):
        ManipulationClassification('ONet', device='cpu', **args)
    with pytest.raises(error):
        JaxFlow('ONet', **args)


class FakeRGBData:
    """The least of a Dataset of RGB patches that the trainer's checks read."""

    def is_raw_and_rgb(self):
        return False

    def next_training_batch(self, batch_id, batch_size, rgb_patch_size):
        return np.zeros((batch_size, rgb_patch_size, rgb_patch_size, 3), np.float32)
