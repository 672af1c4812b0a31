"""awgn, gamma, median, ``median_switch``, ``residual`` and the fused pooled
branches of the PyTorch port against the JAX package's, and the joint step
with all seven manipulations (an 8-class FAN), on the CPU at raw patch 16,
batch 2, inputs drawn with numpy.

Tolerances, each stated where it is checked:

- awgn (its noise passed in) and median: values bit-equal. median's gradient
  bit-equal under an integer-valued cotangent (the same neighbour takes each
  pixel's cotangent, ties included) and within ``SUM_ATOL`` under a random
  one (a pixel that is the median of several windows sums their cotangents
  in another order). awgn's gradient within ``TRIG_ATOL``: the soft
  rounding's cos differs by an ulp between the two libraries.
- ``median_switch`` equals ``median(x, k)`` bit for bit, value and gradient,
  for every index the workflow draws.
- gamma: values within ``POW_ATOL``; powf differs by an ulp between the two
  libraries (a Python int exponent is exact multiplication in both). Its
  gradient within ``GAMMA_GRAD_RTOL`` of its scale: the ulp of x**s is
  multiplied by the soft rounding's frequency, 2π·255.
- residual within 1e-6 (float32 summation order); the pooled branches and
  the fused expansion at the JAX test's ``atol=2e-5, rtol=1e-4``.
- the 8-class step: loss parts within 1e-5 relative, each FAN leaf's
  gradient within ``GRAD_RTOL`` of its scale (``test_torch_train_step``'s
  bound) and each INet leaf's within ``NIP_GRAD_RTOL``: awgn and gamma
  differentiate the soft rounding of 255·y, whose gradient 1 - cos(2π·255·y)
  turns the float32 ulp by which the two packages' developed RGB differ
  (its convolutions sum in other orders) into ~1e-4 of the branch's
  gradient (measured up to 1.6e-4 of a leaf's scale).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.ops import manipulations as jmanips
from neural_imaging_tpu.ops import ops as jops
from neural_imaging_tpu.workflows import ManipulationClassification as JaxFlow
from neural_imaging_tpu_torch.models import base
from neural_imaging_tpu_torch.ops import manipulations as manips
from neural_imaging_tpu_torch.ops import ops, quantization
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    CANONICAL_ORDER, N_STRENGTH_CANDIDATES, ManipulationClassification, compare_probabilities)
from test_torch_train_step import (FAN_ARGS, PATCH, RUN_DIR, as_port_leaves,
                                   assert_gradients_close, assert_parts_close, camera_batches,
                                   fan_weights, port_leaves)

torch.set_num_threads(1)

SEVEN = ['sharpen', 'resample', 'gaussian', 'jpeg', 'awgn', 'gamma', 'median']
MEDIAN_CANDIDATES = [3, 5, 7, 9]
SUM_ATOL = 2e-6
TRIG_ATOL = 1e-6
POW_ATOL = 2.4e-7
GAMMA_GRAD_RTOL = 1e-3
NIP_GRAD_RTOL = 1e-3


def image(seed, shape=(2, 16, 16, 3)):
    """NHWC float32 in [0, 1] with saturated blocks (median ties)."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    x[0, 2:8, 2:8, :] = 1.0
    x[-1, 5:12, 3:9, 1] = 0.0
    return x


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def jax_vjp(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def port_vjp(fn, x, g):
    xt = nchw(x).requires_grad_(True)
    y = fn(xt)
    y.backward(nchw(g))
    return nhwc(y), nhwc(xt.grad)


def cotangents(seed, shape):
    rng = np.random.default_rng(seed)
    return {'integer': rng.integers(-3, 4, shape).astype(np.float32),
            'random': rng.standard_normal(shape).astype(np.float32)}


# -- the manipulations --------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['soft_round', 'soft_quantization', 'quantize_and_clip'])
def test_soft_quantization_matches_reference(name):
    """Values bit-equal (hard rounding); gradients within ``TRIG_ATOL``."""
    x = 1.2 * image(1) - 0.1
    g = cotangents(2, x.shape)['random']
    scale = 255.0 if name == 'soft_round' else 1.0
    y_ref, g_ref = jax_vjp(getattr(jops, name), scale * x, g)
    y, gp = port_vjp(getattr(quantization, name), scale * x, g)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(gp, g_ref, atol=TRIG_ATOL)


@pytest.mark.parametrize('traced', [False, True], ids=['fixed', 'traced'])
def test_awgn_matches_reference(traced):
    """awgn with the same noise in both: the fixed strength 5.1 (a Python
    float, /255) and a strength in a 0-d float32 tensor (the traced form)."""
    x = image(3)
    noise = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    g = cotangents(5, x.shape)['random']
    s = 3.7 if traced else manips.DEFAULT_STRENGTHS['awgn']

    def reference(v):
        strength = jnp.float32(s) / 255.0 if traced else s / 255.0
        return jnp.clip(jops.soft_quantization(v + strength * jnp.asarray(noise)), 0, 1)

    registry = manips.TRACED_MANIPULATIONS if traced else manips.MANIPULATIONS
    y_ref, g_ref = jax_vjp(reference, x, g)
    y, gp = port_vjp(lambda v: registry['awgn'](v, torch.tensor(s) if traced else s,
                                                nchw(noise)), x, g)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(gp, g_ref, atol=TRIG_ATOL)


def test_awgn_draws_from_its_generator_only():
    """Without noise awgn draws from the generator it is given (float32,
    rounded to x's dtype), and refuses to run without one."""
    x = nchw(image(6))
    a = manips.awgn(x, 0.02, generator=torch.Generator().manual_seed(9))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, manips.awgn(x, 0.02, noise))
    with pytest.raises(ValueError, match='Generator'):
        manips.awgn(x, 0.02)


@pytest.mark.parametrize('strength', [3, 3.0, 2.5, 'traced'])
def test_gamma_matches_reference(strength):
    """The default int strength (``lax.integer_pow`` in both), float
    strengths (powf) and a 0-d float32 tensor (the traced form)."""
    x = image(7)
    g = cotangents(8, x.shape)['random']
    if strength == 'traced':
        y_ref, g_ref = jax_vjp(lambda v: jax.jit(jmanips.gamma)(v, jnp.float32(2.7)), x, g)
        y, gp = port_vjp(lambda v: manips.TRACED_MANIPULATIONS['gamma'](v, torch.tensor(2.7)),
                         x, g)
    else:
        y_ref, g_ref = jax_vjp(lambda v: jmanips.gamma(v, strength), x, g)
        y, gp = port_vjp(lambda v: manips.MANIPULATIONS['gamma'](v, strength), x, g)
    np.testing.assert_allclose(y, y_ref, atol=POW_ATOL, rtol=0)
    assert np.abs(gp - g_ref).max() <= GAMMA_GRAD_RTOL * np.abs(g_ref).max()


@pytest.mark.parametrize('name, strength', [('awgn', 5.1), ('gamma', 3), ('gamma', 2.5),
                                            ('median', 5), ('awgn', 'traced'),
                                            ('gamma', 'traced')])
def test_bf16_branches_match_reference(name, strength):
    """A bfloat16 channel's batch (awgn's noise the reference's bfloat16
    draw): at a Python strength every op rounds to bfloat16 as the
    reference's does, bit-equal; a strength in a 0-d float32 tensor promotes
    the branch to float32 in both (gamma within ``POW_ATOL``). The reference
    runs op by op: jitted on the CPU, XLA drops the bfloat16 rounding of
    the noise before its promotion to float32."""
    key = jax.random.PRNGKey(3)
    xb = jnp.asarray(image(44), jnp.bfloat16)
    x = nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    noise = nchw(np.asarray(jax.random.normal(key, xb.shape, jnp.bfloat16).astype(jnp.float32)))
    if strength == 'traced':
        ref = jmanips.TRACED_MANIPULATIONS[name](xb, jnp.float32(2.7), key)
        got = manips.TRACED_MANIPULATIONS[name](x, torch.tensor(2.7), noise.to(torch.bfloat16))
    else:
        ref = jmanips.MANIPULATIONS[name](xb, strength, key)
        got = manips.MANIPULATIONS[name](x, strength, noise.to(torch.bfloat16))
    assert str(got.dtype).split('.')[-1] == str(ref.dtype)
    atol = POW_ATOL if (name, strength) == ('gamma', 'traced') else 0
    np.testing.assert_allclose(nhwc(got.float()), np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=0)


@pytest.mark.parametrize('kernel', [3, 4, 5, 7, 9])
def test_median_matches_reference(kernel):
    """Each window size the workflow draws (and an even one, made odd), on
    an image with saturated blocks, whose windows hold ties."""
    x = image(9)
    y_ref, _ = jax_vjp(lambda v: jmanips.median(v, kernel), x, x)
    for kind, g in cotangents(10 + kernel, x.shape).items():
        _, g_ref = jax_vjp(lambda v: jmanips.median(v, kernel), x, g)
        y, gp = port_vjp(lambda v: manips.median(v, kernel), x, g)
        np.testing.assert_array_equal(y, y_ref)
        if kind == 'integer':
            np.testing.assert_array_equal(gp, g_ref)
        else:
            np.testing.assert_allclose(gp, g_ref, atol=SUM_ATOL, rtol=0)


@pytest.mark.parametrize('index', range(N_STRENGTH_CANDIDATES))
def test_median_switch_equals_median(index):
    """Every index a step draws, clamped to the candidates as the workflow
    and ``lax.switch`` clamp it: the value and the gradient of
    ``median(x, k)``, bit for bit, ties included."""
    kernel = MEDIAN_CANDIDATES[min(index, len(MEDIAN_CANDIDATES) - 1)]
    x = image(20 + index)
    g = cotangents(30 + index, x.shape)['random']
    y, gp = port_vjp(lambda v: manips.median_switch(v, torch.tensor(index), MEDIAN_CANDIDATES),
                     x, g)
    y_k, g_k = port_vjp(lambda v: manips.median(v, kernel), x, g)
    np.testing.assert_array_equal(y, y_k)
    np.testing.assert_array_equal(gp, g_k)


def test_median_switch_matches_reference_switch():
    """Against the reference's ``median_switch`` (``lax.switch`` over
    ``median``) with the same index."""
    x = image(40)
    for index in (0, 2):
        y_ref = np.asarray(jax.jit(jmanips.median_switch, static_argnums=2)(
            jnp.asarray(x), jnp.int32(index), tuple(MEDIAN_CANDIDATES)))
        y = nhwc(manips.median_switch(nchw(x), torch.tensor(index), MEDIAN_CANDIDATES))
        np.testing.assert_array_equal(y, y_ref)


@pytest.mark.parametrize('hsv', [False, True], ids=['rgb', 'hsv'])
def test_residual_matches_reference(hsv):
    x = image(41)
    np.testing.assert_allclose(nhwc(manips.residual(nchw(x), hsv)),
                               np.asarray(jmanips.residual(jnp.asarray(x), hsv)), atol=1e-6)


@pytest.mark.parametrize('name, strength', [('gaussian', 0.83), ('gaussian', 2.0),
                                            ('resample', 50), ('resample', 60)])
def test_pooled_branches_match_reference(name, strength):
    """The exact fused manipulate-then-pool branches (resample at 60 takes
    the two-op form), against the reference's and against the port's own
    two-op form."""
    x = image(42, (2, 32, 32, 3))
    got = manips.POOLED_MANIPULATIONS[name](nchw(x), strength)
    ref = jmanips.POOLED_MANIPULATIONS[name](jnp.asarray(x), strength)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=2e-5, rtol=1e-4)
    two_op = ops.avg_pool(manips.MANIPULATIONS[name](nchw(x), strength), 2)
    np.testing.assert_allclose(got.numpy(), two_op.numpy(), atol=2e-5, rtol=1e-4)


def test_registries_hold_all_seven():
    assert sorted(manips.MANIPULATIONS) == sorted(jmanips.MANIPULATIONS) == sorted(SEVEN)
    assert manips.DEFAULT_STRENGTHS == jmanips.DEFAULT_STRENGTHS
    assert manips.STRENGTH_RANGES == jmanips.STRENGTH_RANGES
    assert sorted(manips.TRACED_MANIPULATIONS) == sorted(jmanips.TRACED_MANIPULATIONS)
    assert sorted(manips.POOLED_MANIPULATIONS) == sorted(jmanips.POOLED_MANIPULATIONS)
    assert list(CANONICAL_ORDER) == SEVEN


# -- the workflow with all seven ----------------------------------------------------------------

def reference_noise(ref, key, shape):
    """awgn's noise as the reference's ``_manipulate`` draws it from ``key``:
    one split per manipulation in class order, awgn's normal from its own
    sub-key, in the channel dtype."""
    for name in ref._operations:
        key, sub = jax.random.split(key)
        if name == 'awgn':
            return np.asarray(jax.random.normal(sub, shape, dtype=ref._channel_dtype))
    return None


def eight_class_flows(remat=False, trainable=('nip',)):
    """The JAX flow and the port's with all seven manipulations: the
    ``m_quality`` INet, the QF-50 channel and a narrow 8-class FAN whose
    weights are drawn with numpy and given to both."""
    ref = JaxFlow('INet', manipulations=SEVEN, fan_args=FAN_ARGS, trainable=set(trainable),
                  raw_patch_size=PATCH, nip_args={'conv_precision': 'highest'})
    weights = fan_weights(ref.fan.params)
    ref.fan.params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in weights.items()},
                                                  sep='/')
    ref.nip.load_model(f'{RUN_DIR}/models/inet')
    ref.params = ref._collect_params()
    port = ManipulationClassification('INet', manipulations=SEVEN, fan_args=FAN_ARGS,
                                      trainable=set(trainable), raw_patch_size=PATCH,
                                      nip_args={'conv_precision': 'highest'}, remat=remat,
                                      device='cpu')
    port.fan.module.load_state_dict(base.convert_params(weights), strict=True)
    port.nip.load_model(f'{RUN_DIR}/models/inet')
    port._snapshot()
    port.reinitialize()
    return ref, port


_REFERENCE = {}


def reference_flow():
    if 'flow' not in _REFERENCE:
        _REFERENCE['flow'] = eight_class_flows()
    return _REFERENCE['flow']


def reference_step(ref, bx, by, scalars=None, indices=None):
    """The reference's loss, parts and gradients (λ_nip 0.1) from
    ``_losses`` under ``PRNGKey(0)``, the awgn noise that key gives, and its
    channel output and probabilities (NHWC numpy)."""
    key = jax.random.PRNGKey(0)
    cache = 'grads' if scalars is None else 'grads_rand'
    if cache not in ref._jitted:
        def loss_of(tparams, fparams, x, y, q_luma, q_chroma, *strengths):
            params = {**fparams, **tparams}
            loss, parts = ref._losses(params, x, y, key, q_luma, q_chroma, jnp.float32(0.1),
                                      jnp.float32(0.0), *strengths)
            _, _, batch_C, _, probs = ref._forward(params, x, key, q_luma, q_chroma, *strengths)
            return loss, (parts, batch_C, probs)
        ref._jitted[cache] = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    q_luma, q_chroma = (jnp.asarray(q) for q in ref._channel_qtables())
    x, y = jops.normalize_batch(jnp.asarray(bx)), jops.normalize_batch(jnp.asarray(by))
    strengths = () if scalars is None else (jnp.asarray(scalars), jnp.asarray(indices))
    (loss, (parts, batch_C, probs)), grads = ref._jitted[cache](
        ref._train_partition(ref.params), ref._frozen_partition(ref.params), x, y, q_luma,
        q_chroma, *strengths)
    noise = reference_noise(ref, key, (bx.shape[0], 2 * PATCH, 2 * PATCH, 3))
    return (float(loss), {k: float(v) for k, v in parts.items()}, as_port_leaves(grads),
            torch.from_numpy(noise.copy()), np.asarray(batch_C), np.asarray(probs))


def assert_step_gradients_close(grads, ref_grads):
    assert_gradients_close({'fan': grads['fan']}, {'fan': ref_grads['fan']})
    assert grads.keys() == ref_grads.keys() and grads['nip'].keys() == ref_grads['nip'].keys()
    for name, g_ref in ref_grads['nip'].items():
        scale = np.abs(g_ref).max()
        err = np.abs(grads['nip'][name] - g_ref).max()
        assert 0 < scale and err <= NIP_GRAD_RTOL * scale, f'nip/{name}: {err} vs {scale}'


def test_eight_class_flow_builds_as_the_reference():
    ref, port = reference_flow()
    assert port._forensics_classes == ref._forensics_classes == [
        'native', 'sharpen:1', 'resample:50', 'gaussian:0.83', 'jpeg:80', 'awgn:5.1', 'gamma:3',
        'median:3']
    assert port.n_classes == 8 and port.summary() == ref.summary()
    assert port.fan.count_parameters() == ref.fan.count_parameters()
    # the median windows the flow's steps draw from, as median_switch's tests take them
    assert port._strength_candidates['median'] == MEDIAN_CANDIDATES


@pytest.mark.parametrize('remat', [False, True], ids=['plain', 'remat'])
def test_eight_class_step_matches_reference(remat):
    """One step's loss parts and gradients (INet and FAN trainable) at the
    fixed strengths, awgn's noise derived from the reference's key; with
    ``remat`` the port recomputes the NIP and the manipulations in the
    backward pass with the same noise."""
    ref, port = reference_flow()
    if remat:
        port = eight_class_flows(remat=True)[1]
    bx, by = camera_batches(70)
    ref_loss, ref_parts, ref_grads, noise, _, _ = reference_step(ref, bx, by)
    loss, parts, grads = port.loss_and_gradients(bx, by, 0.1, noise=noise)
    assert_parts_close(loss, parts, ref_loss, ref_parts)
    assert_step_gradients_close(port_leaves(grads), ref_grads)


@pytest.mark.parametrize('draw', range(2))
def test_eight_class_step_with_shared_strengths(draw):
    """The same with randomized strengths shared by both packages; the median
    index picks k = 5 in draw 0 and k = 9 in draw 1. The jpeg class is
    compressed twice (the manipulation, then the channel), which leaves some
    of its channel coefficients at rounding ties; one that rounds the other
    way in the two packages changes its 8x8 block and the CE of its rows
    (draw 1). Where that happens the flips must lie in the jpeg class alone,
    the NIP's loss still agrees within 1e-5, the probabilities within
    ``compare_probabilities`` and the CE and channel loss within 1e-3, as
    ``test_torch_train_step.test_losses_with_shared_strengths`` holds them."""
    ref, port = reference_flow()
    rng = np.random.default_rng(100 + draw)
    lo = np.array([jmanips.STRENGTH_RANGES[m][0] for m in SEVEN], np.float32)
    hi = np.array([jmanips.STRENGTH_RANGES[m][1] for m in SEVEN], np.float32)
    scalars = (lo + (hi - lo) * rng.random(len(SEVEN))).astype(np.float32)
    indices = rng.integers(0, N_STRENGTH_CANDIDATES, len(SEVEN)).astype(np.int32)
    indices[SEVEN.index('median')] = (1, 6)[draw]
    bx, by = camera_batches(80 + draw)
    ref_loss, ref_parts, ref_grads, noise, c_ref, probs_ref = reference_step(
        ref, bx, by, scalars, indices)
    strengths = torch.from_numpy(scalars), torch.from_numpy(indices.astype(np.int64))
    loss, parts, grads = port.loss_and_gradients(bx, by, 0.1, strength_scalars=strengths[0],
                                                 strength_indices=strengths[1], noise=noise)
    with torch.no_grad():
        _, _, c, _, probs = port._forward(port._batch(bx).permute(0, 3, 1, 2),
                                          *port._channel_qtables(), *strengths,
                                          noise.permute(0, 3, 1, 2))
    n, h, w, ch = c_ref.shape
    blocks = np.abs(nhwc(c) - c_ref).reshape(n, h // 8, 8, w // 8, 8, ch).max(axis=(2, 4))
    flips = (blocks > 1e-5).reshape(port.n_classes, -1).sum(axis=1)
    if not flips.any():
        assert_parts_close(loss, parts, ref_loss, ref_parts)
        assert_step_gradients_close(port_leaves(grads), ref_grads)
        return
    jpeg = 1 + SEVEN.index('jpeg')
    assert flips[jpeg] and not np.delete(flips, jpeg).any(), flips
    compare_probabilities(probs, probs_ref)
    np.testing.assert_allclose(float(parts['nip']), ref_parts['nip'], rtol=1e-5)
    for name in ('ce', 'dcn'):
        np.testing.assert_allclose(float(parts[name]), ref_parts[name], rtol=1e-3, err_msg=name)


def test_fused_pooled_expansion_matches_reference():
    """``_manipulate(pool=True)`` with all seven manipulations against the
    reference's (awgn's noise from its key) and against the port's own
    ``avg_pool(_manipulate(...))``, at the JAX test's tolerance."""
    ref, port = reference_flow()
    y = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    expected = np.asarray(ref._manipulate(jnp.asarray(y), key, pool=True))
    noise = nchw(reference_noise(ref, key, y.shape))
    fused = port._manipulate(nchw(y), noise=noise, pool=True)
    np.testing.assert_allclose(nhwc(fused), expected, atol=2e-5, rtol=1e-4)
    two_op = ops.avg_pool(port._manipulate(nchw(y), noise=noise), 2)
    np.testing.assert_allclose(fused.numpy(), two_op.numpy(), atol=2e-5, rtol=1e-4)


def test_override_manipulations_match_reference():
    """``run_manipulations(override=...)`` at other strengths: every class but
    awgn against the reference's; awgn's against ``awgn`` with the noise the
    flow's generator gives."""
    ref, port = reference_flow()
    override = {'sharpen': 0.5, 'resample': 60, 'gaussian': 1.5, 'jpeg': 70, 'awgn': 3.0,
                'gamma': 2.0, 'median': 5}
    y = image(43)
    port.reinitialize()
    got = port.run_manipulations(y, override=override).numpy().reshape(8, *y.shape)
    expected = np.asarray(ref.run_manipulations(y, override=override)).reshape(8, *y.shape)
    awgn = 1 + SEVEN.index('awgn')
    keep = [c for c in range(8) if c != awgn]
    np.testing.assert_allclose(got[keep], expected[keep], atol=POW_ATOL * 8, rtol=0)
    noise = torch.randn((2, 3, 16, 16), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got[awgn], nhwc(manips.awgn(nchw(y), 3.0 / 255.0, noise)))


def test_augmented_steps_draw_every_manipulation():
    """Augmented steps and ``training_scan`` with all seven: finite losses,
    the weights move, and a randomized forward classifies every class."""
    from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
    _, port = eight_class_flows()
    port.nan_check = True
    bx, by = camera_batches(90)
    before = port_leaves(port._collect_params())
    for _ in range(2):
        loss, _ = port.training_step(bx, by, 0.1, augment=True)
        assert np.isfinite(float(loss))
    data = SimpleNamespace(_loaded_data='xy', data={'training': {'x': bx, 'y': by}})
    sampler = DeviceSampler(data, batch_size=2, rgb_patch_size=2 * PATCH, device='cpu', seed=1)
    losses, _ = port.training_scan(sampler, 2, 0.1, augment=True)
    port.assert_finite()
    assert bool(torch.isfinite(losses).all())
    after = port_leaves(port._collect_params())
    assert all(np.abs(after[p][k] - before[p][k]).max() > 0 for p in after for k in after[p])
    probs = port.run_workflow(bx.astype(np.float32) / 65535.0, augment=True)[-1]
    assert probs.shape == (16, 8) and bool(torch.isfinite(probs).all())


def test_bf16_channel_expands_all_seven():
    """A bfloat16 channel with all seven manipulations: the expansion is
    bfloat16 at fixed and randomized strengths (awgn's noise drawn in
    float32 and rounded once), and an augmented step's loss is finite."""
    port = ManipulationClassification('INet', manipulations=SEVEN, fan_args=FAN_ARGS,
                                      trainable={'nip'}, raw_patch_size=PATCH,
                                      channel_dtype='bfloat16', device='cpu')
    y = nchw(image(45))
    assert port._manipulate(y).dtype == torch.bfloat16
    assert port._manipulate(y, *port._sample_strengths()).dtype == torch.bfloat16
    noise = port._awgn_noise(y.shape, torch.bfloat16)
    assert noise.dtype == torch.bfloat16 and noise.shape == y.shape
    bx, by = camera_batches(95)
    loss, _ = port.training_step(bx, by, 0.1, augment=True)
    assert np.isfinite(float(loss))


def test_default_manipulations_are_the_reference_four():
    """Without a list both packages take sharpen, resample, gaussian, jpeg."""
    port = ManipulationClassification(raw_patch_size=PATCH, fan_args=FAN_ARGS, device='cpu')
    ref = JaxFlow('INet', fan_args=FAN_ARGS, raw_patch_size=PATCH)
    assert port._forensics_classes == ref._forensics_classes and port.n_classes == 5
