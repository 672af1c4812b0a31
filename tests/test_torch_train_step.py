"""The joint manipulation-classification training step of the PyTorch port
against the JAX package's, on the CPU at raw patch 16, batch 2, with a
narrow FAN (8 filters, 2 convolutions) whose weights are drawn with numpy and
given to both, and the shipped INet of the ``m_quality`` run; and the
trainable q-table run ``m_quality_qtables`` with its own FAN and INet.

Tolerances, each leaf held to its own scale (its largest |entry| in the
reference): loss parts within 1e-5 relative; gradients within
``GRAD_RTOL`` of their leaf's scale (float32, other summation orders).
Adam's first steps move each parameter by about lr·sign(g), so an entry whose
gradient is rounding noise in one package may move the other way: after
``STEPS`` steps an entry may differ by up to 2·lr per step, and every entry
whose gradient is above ``GRAD_RTOL`` of its leaf's scale must agree to
``UPDATE_ATOL``."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.models import jpeg as jjpeg
from neural_imaging_tpu.ops import manipulations as jmanips
from neural_imaging_tpu.ops import ops as jops
from neural_imaging_tpu.workflows import ManipulationClassification as JaxFlow
from neural_imaging_tpu_torch.models import base
from neural_imaging_tpu_torch.ops import manipulations as manips
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    N_STRENGTH_CANDIDATES, ManipulationClassification, compare_probabilities)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')
QTABLES_RUN_DIR = os.path.join(ROOT, 'data/m_quality_qtables/QualityRef/INet/fixed-nip/'
                               'lc-0.1000/000')
BF16_LOG = os.path.join(ROOT, 'data/m_manipjpeg_bf16/QualityRef/INet/ln-0.0050/fixed-codec/000/'
                        'training.json')
PATCH, BATCH = 16, 2
FAN_ARGS = {'n_filters': 8, 'n_convolutions': 2}
MANIPULATIONS = ['sharpen', 'resample', 'gaussian', 'jpeg']
LR, STEPS = 1e-4, 2
GRAD_RTOL = 1e-4
UPDATE_ATOL = 1e-6

# name → (distribution, trainable, λ_nip, λ_dcn)
CONFIGS = {
    'pool': ({'downsampling': 'pool:2'}, {'nip'}, 0.1, 0.0),
    'bilinear': ({'downsampling': 'bilinear'}, {'nip'}, 0.1, 0.0),
    'none': ({'downsampling': 'none'}, {'nip'}, 0.1, 0.0),
    'qtables': ({'downsampling': 'pool', 'compression': 'jpeg',
                 'compression_params': {'quality': 50, 'codec': 'soft', 'trainable': True}},
                {'dcn'}, 0.0, 0.1),
}
# the reference's 'libjpeg' channel, which its flow replaces by 'soft' rounding
CONFIGS['libjpeg'] = ({'downsampling': 'pool:2', 'compression': 'jpeg',
                       'compression_params': {'quality': 50, 'codec': 'libjpeg'}},
                      {'nip'}, 0.1, 0.0)
CONFIGS['qtables_run'] = CONFIGS['qtables']
# configurations restored from a shipped run (its FAN and INet), not built
RUNS = {'qtables_run': QTABLES_RUN_DIR}


def flat_params(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


def fan_weights(reference, seed=7):
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


class PallasJPEG(jjpeg.DifferentiableJPEG):
    """The reference's differentiable JPEG through its Pallas core (interpret
    mode on the CPU) at every size. Its q-table gradient, Σ g·(r(u) − u r'(u))
    with r the soft rounding, is the one the port's K1 backward computes;
    the reference's XLA form, which it takes on the CPU and below 256 px,
    differentiates round(u) − u r'(u) instead."""

    def __call__(self, x, params=None, q_luma=None, q_chroma=None):
        params = params if params is not None else self.params
        q_luma = params['q_mtx_luma'] if q_luma is None else q_luma
        q_chroma = params['q_mtx_chroma'] if q_chroma is None else q_chroma
        return jjpeg.jpeg_forward(jnp.asarray(x, jnp.float32), q_luma, q_chroma,
                                  rounding=self.rounding_approximation, impl='pallas')


def make_flows(config):
    """The JAX flow and the port's, with the same weights: the narrow FAN's
    drawn by ``fan_weights`` and the ``m_quality`` run's INet, or a shipped
    run's own (``RUNS``). A trainable channel's reference runs through
    ``PallasJPEG``."""
    distribution, trainable, _, _ = CONFIGS[config]
    run = RUNS.get(config)
    if run:
        with open(os.path.join(run, 'training.json')) as f:
            log = json.load(f)
        fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
        nip_args = log['nip']['args']
    else:
        fan_args, nip_args = FAN_ARGS, {'conv_precision': 'highest'}
    ref = JaxFlow('INet', manipulations=MANIPULATIONS, distribution=distribution,
                  fan_args=fan_args, trainable=trainable, raw_patch_size=PATCH,
                  nip_args=nip_args)
    if run:
        ref.fan.load_model(os.path.join(run, 'models/fan'))
    else:
        weights = fan_weights(ref.fan.params)
        ref.fan.params = traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in weights.items()}, sep='/')
    ref.nip.load_model(os.path.join(run or RUN_DIR, 'models/inet'))
    if ref.codec.trainable:
        ref.codec._model.__class__ = PallasJPEG
    ref.params = ref._collect_params()
    ref.opt_state = ref._tx.init(ref._train_partition(ref.params))
    ref.initial = jax.tree.map(jnp.copy, ref.params)

    if run:
        port = ManipulationClassification.restore(run, PATCH, trainable=trainable, device='cpu')
    else:
        port = ManipulationClassification('INet', manipulations=MANIPULATIONS,
                                          distribution=distribution, fan_args=fan_args,
                                          trainable=trainable, raw_patch_size=PATCH,
                                          nip_args=nip_args, device='cpu')
        port.fan.module.load_state_dict(base.convert_params(weights), strict=True)
        port.nip.load_model(os.path.join(RUN_DIR, 'models/inet'))
        port._snapshot()
        port.reinitialize()
    return ref, port


_FLOWS = {}


def flows(config):
    """``make_flows(config)``, built once per module and reset to its first
    state (weights, optimizer states) on every call; the reference keeps its
    compiled programs."""
    if config not in _FLOWS:
        _FLOWS[config] = make_flows(config)
    ref, port = _FLOWS[config]
    ref.params = jax.tree.map(jnp.copy, ref.initial)
    ref.opt_state = ref._tx.init(ref._train_partition(ref.params))
    ref._push_params_to_models()
    port.reinitialize()
    return ref, port


def camera_batches(seed):
    """uint16 RAW stacks and their uint8 developed RGB targets."""
    pairs = [fixtures.make_raw_rgb_pair(2 * PATCH, 2 * PATCH, seed=seed + i)
             for i in range(BATCH)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def as_port_leaves(tree, transposed=frozenset()):
    """A JAX parameter (or gradient) tree as {part: {port name: array}};
    ``transposed``: the port's names of transposed-conv kernels."""
    out = {}
    for part, leaves in tree.items():
        flat = flat_params(leaves)
        out[part] = (flat if part == 'dcn' else
                     {k: v.numpy() for k, v in base.convert_params(flat, transposed).items()})
    return out


def port_leaves(tree):
    return {part: {k: v.detach().numpy().copy() for k, v in leaves.items()}
            for part, leaves in tree.items()}


def reference_gradients(ref, bx, by, l_nip, l_dcn, scalars=None, indices=None,
                        transposed=frozenset()):
    """The reference's loss, its parts and its gradients over the trainable
    partition, from one program compiled per flow."""
    key = 'grads' if scalars is None else 'grads_rand'
    if key not in ref._jitted:
        def loss_of(tparams, fparams, x, y, q_luma, q_chroma, l_nip, l_dcn, *strengths):
            params = {**fparams, **tparams}
            k = jax.random.PRNGKey(0)
            loss, parts = ref._losses(params, x, y, k, q_luma, q_chroma, l_nip, l_dcn,
                                      *strengths)
            _, _, batch_C, _, probs = ref._forward(params, x, k, q_luma, q_chroma, *strengths)
            return loss, (parts, batch_C, probs)
        ref._jitted[key] = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    q_luma, q_chroma = (jnp.asarray(q) for q in ref._channel_qtables())
    x, y = jops.normalize_batch(jnp.asarray(bx)), jops.normalize_batch(jnp.asarray(by))
    strengths = () if scalars is None else (jnp.asarray(scalars), jnp.asarray(indices))
    (loss, (parts, batch_C, probs)), grads = ref._jitted[key](
        ref._train_partition(ref.params), ref._frozen_partition(ref.params), x, y, q_luma,
        q_chroma, jnp.float32(l_nip), jnp.float32(l_dcn), *strengths)
    ref.last_channel = np.asarray(batch_C), np.asarray(probs)
    return float(loss), {k: float(v) for k, v in parts.items()}, as_port_leaves(grads, transposed)


def assert_parts_close(loss, parts, ref_loss, ref_parts):
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    for name, value in ref_parts.items():
        np.testing.assert_allclose(float(parts[name]), value, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def assert_gradients_close(grads, ref_grads):
    assert grads.keys() == ref_grads.keys()
    for part, leaves in ref_grads.items():
        assert leaves.keys() == grads[part].keys(), part
        for name, g_ref in leaves.items():
            scale = np.abs(g_ref).max()
            assert scale > 0, f'{part}/{name}: no gradient'
            err = np.abs(grads[part][name] - g_ref).max()
            assert err <= GRAD_RTOL * scale, f'{part}/{name}: {err} vs scale {scale}'


@pytest.mark.parametrize('config', ['pool', 'bilinear', 'qtables', 'libjpeg'])
def test_step_gradients_match_reference(config):
    """Loss parts and every trainable leaf's gradient at fixed strengths."""
    ref, port = flows(config)
    _, _, l_nip, l_dcn = CONFIGS[config]
    bx, by = camera_batches(40)
    ref_loss, ref_parts, ref_grads = reference_gradients(ref, bx, by, l_nip, l_dcn)
    loss, parts, grads = port.loss_and_gradients(bx, by, l_nip, l_dcn)
    assert_parts_close(loss, parts, ref_loss, ref_parts)
    assert_gradients_close(port_leaves(grads), ref_grads)


@pytest.mark.parametrize('config', ['pool', 'qtables', 'libjpeg'])
def test_updated_parameters_match_reference(config):
    """Two Adam steps of each package from the same weights and batches."""
    ref, port = flows(config)
    _, _, l_nip, l_dcn = CONFIGS[config]
    before = port_leaves(port._collect_params())
    _, _, first_grads = port.loss_and_gradients(*camera_batches(50), l_nip, l_dcn)
    for step in range(STEPS):
        bx, by = camera_batches(50 + 10 * step)
        ref_loss, ref_parts = ref.training_step(bx, by, l_nip, l_dcn, learning_rate=LR)
        loss, parts = port.training_step(bx, by, l_nip, l_dcn, learning_rate=LR)
        assert_parts_close(loss, parts, float(ref_loss), {k: float(v) for k, v in ref_parts.items()})
    after_ref = as_port_leaves(ref._train_partition(ref.params))
    after = port_leaves(port._train_partition(port._collect_params()))
    for part, leaves in after_ref.items():
        for name, p_ref in leaves.items():
            p, p0 = after[part][name], before[part][name]
            diff = np.abs(p - p_ref)
            assert diff.max() <= 2 * LR * STEPS + UPDATE_ATOL, f'{part}/{name}'
            g = port_leaves(first_grads)[part][name]
            clear = np.abs(g) > GRAD_RTOL * np.abs(g).max()
            assert diff[clear].max(initial=0) <= UPDATE_ATOL, f'{part}/{name}'
            assert np.abs(p - p0).max() > 0.5 * LR, f'{part}/{name} did not move'
    if config == 'qtables':
        tables = port.codec._model.params
        np.testing.assert_allclose(tables['q_mtx_luma'].detach().numpy(),
                                   np.asarray(ref.params['dcn']['q_mtx_luma']),
                                   atol=2 * LR * STEPS)
        assert port.codec.estimate_qf() == ref.codec.estimate_qf() == 50


def channel_flips(ref, port, bx, scalars, indices):
    """The JPEG channel's 8x8 blocks that differ by more than 1e-5 between the
    two packages' forwards (the reference's from its last
    ``reference_gradients``), per class, and the two probability arrays."""
    c_ref, probs_ref = ref.last_channel
    with torch.no_grad():
        got = port._forward(port._batch(bx).permute(0, 3, 1, 2), *port._channel_qtables(),
                            torch.from_numpy(scalars), torch.from_numpy(indices.astype(np.int64)))
    c = got[2].permute(0, 2, 3, 1).numpy()
    n, h, w, ch = c.shape
    blocks = np.abs(c - c_ref).reshape(n, h // 8, 8, w // 8, 8, ch).max(axis=(2, 4))
    return (blocks > 1e-5).reshape(port.n_classes, -1).sum(axis=1), got[-1], probs_ref


def test_trainable_qtable_run_step():
    """One step of the shipped trainable q-table run (its own FAN and INet,
    the NIP frozen, λ_dcn 0.1) in both packages: loss parts within 1e-5, and
    the 'dcn' slot (the q-tables) moving the same way in both: by up to 2·lr
    per entry, and in the same direction wherever the gradient is above 1%
    of its table's scale (the two packages' q-table gradients agree within
    0.2% of that scale at this batch)."""
    ref, port = flows('qtables_run')
    bx, by = camera_batches(40)
    _, _, ref_grads = reference_gradients(ref, bx, by, 0.0, 0.1)
    before = port_leaves(port._collect_params())['dcn']
    ref_loss, ref_parts = ref.training_step(bx, by, 0.0, 0.1, learning_rate=LR)
    loss, parts = port.training_step(bx, by, 0.0, 0.1, learning_rate=LR)
    assert_parts_close(loss, parts, float(ref_loss), {k: float(v) for k, v in ref_parts.items()})
    after = port_leaves(port._collect_params())['dcn']
    for name, g in ref_grads['dcn'].items():
        moved, moved_ref = after[name] - before[name], np.asarray(ref.params['dcn'][name]) - before[name]
        assert np.abs(moved).max() <= 2 * LR and np.abs(moved_ref).max() <= 2 * LR, name
        clear = np.abs(g) > 1e-2 * np.abs(g).max()
        assert clear.sum() > 0
        np.testing.assert_array_equal(np.sign(moved[clear]), np.sign(moved_ref[clear]),
                                      err_msg=name)
        assert port.codec.estimate_qf() == ref.codec.estimate_qf() == 50


@pytest.mark.parametrize('draw', range(4))
def test_losses_with_shared_strengths(draw):
    """``_losses`` of both packages with the same randomized strengths: the
    loss parts within 1e-5 and the gradients within ``GRAD_RTOL`` of their
    scale. The jpeg class is compressed twice (the manipulation, then the
    channel), which leaves some of its channel coefficients at rounding
    ties; one that rounds the other way in the two packages changes its
    8x8 block and the CE of its rows. Where that happens (draws 0 and 1 of
    these 4), the flips must lie in the jpeg class alone, the NIP's loss
    still agrees within 1e-5, the probabilities within
    ``compare_probabilities`` and the CE and channel loss within 1e-3."""
    ref, port = flows('pool')
    rng = np.random.default_rng(draw)
    lo = np.array([jmanips.STRENGTH_RANGES[m][0] for m in MANIPULATIONS], np.float32)
    hi = np.array([jmanips.STRENGTH_RANGES[m][1] for m in MANIPULATIONS], np.float32)
    scalars = (lo + (hi - lo) * rng.random(4)).astype(np.float32)
    indices = rng.integers(0, N_STRENGTH_CANDIDATES, 4).astype(np.int32)
    bx, by = camera_batches(60 + draw)
    ref_loss, ref_parts, ref_grads = reference_gradients(ref, bx, by, 0.1, 0.0, scalars,
                                                         indices)
    loss, parts, grads = port.loss_and_gradients(
        bx, by, 0.1, 0.0, strength_scalars=torch.from_numpy(scalars),
        strength_indices=torch.from_numpy(indices.astype(np.int64)))
    flips, probs, probs_ref = channel_flips(ref, port, bx, scalars, indices)
    if not flips.any():
        assert_parts_close(loss, parts, ref_loss, ref_parts)
        assert_gradients_close(port_leaves(grads), ref_grads)
        return
    assert not flips[:-1].any(), flips
    compare_probabilities(probs, np.asarray(probs_ref))
    np.testing.assert_allclose(float(parts['nip']), ref_parts['nip'], rtol=1e-5)
    for name in ('ce', 'dcn'):
        np.testing.assert_allclose(float(parts[name]), ref_parts[name], rtol=1e-3, err_msg=name)


def rgb_batch(seed):
    return np.stack([fixtures.procedural_image(2 * PATCH, 2 * PATCH, seed=seed + i)
                     for i in range(BATCH)]).astype(np.float32)


@pytest.mark.parametrize('name,strength', [
    ('sharpen', 0.25), ('sharpen', 1.1), ('gaussian', 0.5), ('gaussian', 3.7),
    ('jpeg', 50), ('jpeg', 77), ('resample', 0), ('resample', 3), ('resample', 7)])
def test_traced_manipulations_match_reference(name, strength):
    """Each traced manipulation (resample: its switch at a candidate index)
    against the JAX package's, within 1e-5 on images in [0, 1]."""
    y = rgb_batch(70)
    if name == 'resample':
        candidates = [int(c) for c in np.linspace(*jmanips.STRENGTH_RANGES[name],
                                                  N_STRENGTH_CANDIDATES)]
        expected = jmanips.resample_switch(jnp.asarray(y), jnp.int32(strength), candidates)
        got = manips.resample_switch(torch.from_numpy(y).permute(0, 3, 1, 2),
                                     torch.tensor(strength), candidates)
    else:
        expected = jmanips.TRACED_MANIPULATIONS[name](jnp.asarray(y), jnp.float32(strength))
        got = manips.TRACED_MANIPULATIONS[name](torch.from_numpy(y).permute(0, 3, 1, 2),
                                                torch.tensor(strength, dtype=torch.float32))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(expected), atol=1e-5)


@pytest.mark.parametrize('config', ['bilinear', 'none'])
def test_downsampling_forward_matches_reference(config):
    """The forward with bilinear or no downsampling, within 1e-5. With no
    downsampling the jpeg class reaches the channel on the manipulation's
    own 8x8 grid, so its coefficients sit at rounding ties and some of its
    blocks round the other way in the two packages (12-16% of them at these
    inputs): there the jpeg class's rows are held by
    ``compare_probabilities`` alone."""
    ref, port = flows(config)
    x = camera_batches(80)[0] / np.float32(65535)
    expected, got = ref.run_workflow(x), port.run_workflow(x)
    exact = slice(None) if config == 'bilinear' else slice(0, -BATCH)
    for name, a, b in zip(('batch_Y', 'batch_c', 'batch_C', 'entropy', 'probabilities'),
                          expected, got):
        a, b = np.asarray(a), b.numpy()
        if name in ('batch_C', 'probabilities'):
            a, b = a[exact], b[exact]
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg=name)
    compare_probabilities(got[-1], np.asarray(expected[-1]))


def test_augmented_forward_matches_reference():
    """run_workflow(augment=True): both draw the same strengths from the
    same numpy seed on the host."""
    ref, port = flows('pool')
    ref._rng, port._rng = np.random.default_rng(3), np.random.default_rng(3)
    x = camera_batches(90)[0] / np.float32(65535)
    for _ in range(2):
        np.testing.assert_allclose(port.run_workflow(x, augment=True)[-1].numpy(),
                                   np.asarray(ref.run_workflow(x, augment=True)[-1]), atol=1e-5)


def test_run_helpers_match_reference():
    ref, port = flows('pool')
    y = rgb_batch(100)
    np.testing.assert_allclose(port.run_rgb_to_fan(y), ref.run_rgb_to_fan(y), atol=1e-5)
    np.testing.assert_allclose(port.run_rgb_to_probabilities(y),
                               ref.run_rgb_to_probabilities(y), atol=1e-5)


@pytest.mark.parametrize('augment', [False, True])
def test_reinitialize_reproduces_the_first_step(augment):
    _, port = flows('qtables')
    bx, by = camera_batches(110)

    def run():
        losses = [port.training_step(bx, by, 0.1, 0.1, augment=augment)[0] for _ in range(2)]
        return losses, port_leaves(port._collect_params())

    first_losses, first = run()
    port.reinitialize()
    again_losses, again = run()
    assert [float(v) for v in first_losses] == [float(v) for v in again_losses]
    for part, leaves in first.items():
        for name, p in leaves.items():
            np.testing.assert_array_equal(again[part][name], p, err_msg=f'{part}/{name}')


def test_nan_guard_raises():
    _, port = flows('pool')
    bx, by = camera_batches(120)
    with torch.no_grad():
        port.nip.module.srgb[0, 0, 0, 0] = float('nan')
    with pytest.raises(RuntimeError, match='NaN'):
        port.training_step(bx, by, 0.1)
    port.reinitialize()
    port.training_step(bx, by, 0.1)
    port.nan_check = False
    with torch.no_grad():
        port.fan.module.head.bias[0] = float('inf')
    port.training_step(bx, by, 0.1)
    with pytest.raises(RuntimeError, match='NaN'):
        port.assert_finite()


def test_restore_refuses_a_channel_precision_it_cannot_honour(tmp_path):
    """The shipped run whose manipulation JPEG ran in bfloat16 (and its INet
    at 'default'): ``restore`` builds it so, and its forward from the same
    developed RGB agrees with the reference's (``compare_probabilities``);
    a log whose channel precision names a dtype the reference does not have
    is refused."""
    run_dir = os.path.dirname(BF16_LOG)
    with open(BF16_LOG) as f:
        log = json.load(f)
    assert log['channel_precision']['manip_jpeg_dtype'] == 'bfloat16'
    port = ManipulationClassification.restore(run_dir, PATCH, device='cpu')
    assert port.channel_precision == log['channel_precision']
    assert port.nip._h.conv_precision == 'default'
    ref = JaxFlow('INet', manipulations=MANIPULATIONS, distribution=log['distribution'],
                  fan_args={k: v for k, v in log['forensics']['args'].items()
                            if k != 'n_classes'},
                  raw_patch_size=PATCH, nip_args=log['nip']['args'],
                  manip_jpeg_dtype='bfloat16')
    ref.fan.load_model(os.path.join(run_dir, 'models/fan'))
    ref.nip.load_model(os.path.join(run_dir, 'models/inet'))
    ref.params = ref._collect_params()
    y = rgb_batch(140)
    compare_probabilities(port.run_rgb_to_probabilities(y), ref.run_rgb_to_probabilities(y))

    log['channel_precision']['manip_jpeg_dtype'] = 'float16'
    (tmp_path / 'training.json').write_text(json.dumps(log))
    shutil.copytree(os.path.join(run_dir, 'models'), tmp_path / 'models')
    with pytest.raises(ValueError, match='manipulation JPEG dtype'):
        ManipulationClassification.restore(str(tmp_path), PATCH, device='cpu')


def test_loss_metrics():
    """The NIP's L1, SSIM and MS-SSIM losses against the reference's."""
    from neural_imaging_tpu.ops import ops as jax_ops
    from neural_imaging_tpu_torch.ops import ops
    a, b = rgb_batch(130), rgb_batch(131)
    for name in ('L2', 'L1', 'SSIM', 'MS-SSIM'):
        # float32 sums over 11x11 windows: SSIM within 1e-5, so 255 (1 - SSIM)
        # within 255e-5
        np.testing.assert_allclose(float(ops.LOSSES[name](torch.from_numpy(a), torch.from_numpy(b))),
                                   float(jax_ops.LOSSES[name](jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-5, atol=0 if name in ('L2', 'L1') else 255e-5,
                                   err_msg=name)


# -- the other camera ISPs -------------------------------------------------------------

NIP_FLOWS = {'UNet': {'n_steps': 3}, 'DNet': {'n_layers': 3, 'n_features': 8}}


def nip_flows(nip, remat=False):
    """The JAX flow and the port's with a narrow UNet or DNet (the JAX
    package's initial weights) trainable, the narrow FAN of ``fan_weights``,
    pool:2 and the QF-50 channel."""
    ref = JaxFlow(nip, manipulations=MANIPULATIONS, fan_args=FAN_ARGS, trainable={'nip'},
                  raw_patch_size=PATCH, nip_args=NIP_FLOWS[nip])
    weights = fan_weights(ref.fan.params)
    ref.fan.params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in weights.items()}, sep='/')
    ref.params = ref._collect_params()
    port = ManipulationClassification(nip, manipulations=MANIPULATIONS, fan_args=FAN_ARGS,
                                      trainable={'nip'}, raw_patch_size=PATCH,
                                      nip_args=NIP_FLOWS[nip], remat=remat, device='cpu')
    port.fan.module.load_state_dict(base.convert_params(weights), strict=True)
    port.nip.module.load_state_dict(
        base.convert_params(flat_params(ref.nip.params),
                            base.transposed_kernels(port.nip.module)), strict=True)
    port._snapshot()
    port.reinitialize()
    return ref, port


@pytest.mark.parametrize('nip', sorted(NIP_FLOWS))
def test_nip_flow_step_matches_reference(nip):
    """The first joint step with a trainable UNet or DNet: loss parts and
    every trainable leaf's gradient, as for INet."""
    ref, port = nip_flows(nip)
    bx, by = camera_batches(60)
    ref_loss, ref_parts, ref_grads = reference_gradients(
        ref, bx, by, 0.005, 0.0, transposed=base.transposed_kernels(port.nip.module))
    loss, parts, grads = port.loss_and_gradients(bx, by, 0.005)
    assert_parts_close(loss, parts, ref_loss, ref_parts)
    assert_gradients_close(port_leaves(grads), ref_grads)


def test_remat_keeps_the_loss_and_gradients():
    """``remat`` recomputes the NIP and the manipulations in the backward
    pass: the same loss, parts and gradients, bit for bit on the CPU."""
    _, plain = nip_flows('UNet')
    _, remat = nip_flows('UNet', remat=True)
    bx, by = camera_batches(62)
    for augment in (False, True):
        args = (plain._sample_strengths_in_graph() if augment else (None, None))
        a = plain.loss_and_gradients(bx, by, 0.005, 0.0, None, *args)
        b = remat.loss_and_gradients(bx, by, 0.005, 0.0, None, *args)
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
        for part, leaves in a[2].items():
            for k, g in leaves.items():
                assert torch.equal(g, b[2][part][k]), f'{part}/{k}'
