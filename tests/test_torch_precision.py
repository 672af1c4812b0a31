"""The port's bfloat16 and precision knobs against the JAX package on the CPU:
INet's 'high' and 'default' conv precisions, the bfloat16 FAN (separate and
fused stem), the bfloat16 plane-form JPEG, the flat pool, the manipulations
on bfloat16 batches, ``bench.py``'s configuration (every knob at once, with
the NIP trainable) and the shipped runs trained with them, at raw patch 16
with a narrow FAN whose weights are drawn with numpy and given to both.

Tolerances, each stated where it is checked:

- JAX on the CPU ignores the matrix-unit precision of float32 operands, so
  its 'high' and 'default' INet are float32. The port rounds the operands as
  a TPU does ('default': to bfloat16; 'high': two bfloat16 terms each).
  'high' agrees within 1e-4. 'default' differs by the operand rounding: a
  relative 2^-9 per operand, two operands and five convs in a row, held to
  ``DEFAULT_MAX`` (8 · 2^-8) in the max and ``DEFAULT_MEAN`` (2^-9) in the
  mean of RGB in [0, 1]. Each emulated conv equals, to 1e-6, a float32 conv
  of pre-rounded operands.
- A bfloat16 op rounds its float32 result once in both packages, so most
  bfloat16 values are bit-equal; where float32 summation orders differ, a
  value may round the other way, by one bfloat16 ulp. A dJPEG coefficient
  that rounds the other way moves its 8x8 block by up to one q step of the
  basis, ``flip_step``.
- Probabilities by ``compare_probabilities`` (|Δp| ≤ 1e-2, same decisions).
- The first step's loss parts within ``BF16_STEP_LOSS_DIFF`` and the
  gradient norms of each trainable part within ``BF16_GRADIENT_NORM_DIFF``,
  the bounds the card's bfloat16 step is held to against the CPU's
  (``compare_steps``).
"""
import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from neural_imaging_tpu.compression.jpeg_helpers import jpeg_qtable
from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data.dataset import Dataset as JaxDataset
from neural_imaging_tpu.models import forensics as jforensics
from neural_imaging_tpu.models import jpeg as jjpeg
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu.ops import color as jcolor
from neural_imaging_tpu.ops import manipulations as jmanips
from neural_imaging_tpu.ops import ops as jops
from neural_imaging_tpu.ops import quantization as jquant
from neural_imaging_tpu.training import validation as jvalidation
from neural_imaging_tpu.workflows import ManipulationClassification as JaxFlow
from neural_imaging_tpu_torch.cli import train_manipulation as cli
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import base, forensics, pipelines
from neural_imaging_tpu_torch.models import jpeg as pjpeg
from neural_imaging_tpu_torch.ops import color, ops
from neural_imaging_tpu_torch.ops import manipulations as manips
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.training import validation
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    BF16_GRADIENT_NORM_DIFF, BF16_STEP_LOSS_DIFF, DECISION_MARGIN,
    ManipulationClassification, compare_probabilities)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import test_fan  # noqa: E402  (the JAX package's re-validation CLI)

torch.set_num_threads(1)

INET_DIR = os.path.join(ROOT, 'data/models/nip/QualityRef/INet_gbrg_5x5/inet')
RUN_DIR = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')
NIP_DIR = os.path.join(ROOT, 'data/models/nip')
SHIPPED = {run: os.path.join(ROOT, f'data/{run}/QualityRef/INet/ln-0.0050/fixed-codec/000')
           for run in ('m_prec_high', 'm_prec_default', 'm_manipjpeg_bf16', 'm_fan_bf16')}
PATCH, BATCH, LR, STEPS = 16, 2, 1e-4, 2
FAN_ARGS = {'n_filters': 8, 'n_convolutions': 2}
MANIPULATIONS = ['sharpen', 'resample', 'gaussian', 'jpeg']
DEFAULT_MAX, DEFAULT_MEAN = 8 * 2 ** -8, 2 ** -9
BF16 = torch.bfloat16

# bench.py's flow, cut to raw patch 16 and a narrow FAN
BENCH = dict(manipulations=MANIPULATIONS,
             distribution={'downsampling': 'pool:2', 'compression': 'jpeg',
                           'compression_params': {'quality': 50, 'codec': 'soft'}},
             trainable={'nip'}, raw_patch_size=PATCH, channel_dtype='bfloat16',
             nip_args={'conv_precision': 'exact'}, channel_jpeg_dtype='bfloat16',
             manip_jpeg_dtype='bfloat16', pool_impl='flat')


def to_numpy(a):
    """A JAX array (bfloat16 too) or an NCHW/other tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)


def nhwc(t):
    return to_numpy(t.permute(0, 2, 3, 1))


def rgb_batch(n=3, p=32):
    return np.stack([jfixtures.procedural_image(p, p, seed=s) for s in range(n)]
                    ).astype(np.float32)


def bf16_ulp(v):
    """One bfloat16 ulp at |v| (8 significant bits)."""
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def flat_params(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


def fan_weights(reference, seed=7):
    """numpy-drawn FAN weights as flax paths: the constrained filter's
    initial value plus noise, LeCun-scaled kernels, small biases."""
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


# -- (a) INet's conv precisions ----------------------------------------------------------------

@pytest.mark.parametrize('precision', ['default', 'high'])
def test_emulated_conv_is_a_float32_conv_of_rounded_operands(precision):
    """'default' is one float32 conv of the bfloat16-rounded operands; 'high'
    the three float32 convs hi·hi + hi·lo + lo·hi of their two bfloat16
    terms (summed here in float64): within 1e-6 of the result's scale. The
    gradient passes the rounding unchanged."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 12, 16, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 12, 5, 5)).astype(np.float32))

    def parts(t):
        hi = t.to(BF16).to(torch.float32)
        return hi, (t - hi).to(BF16).to(torch.float32)

    (xh, xl), (wh, wl) = parts(x), parts(w)
    if precision == 'default':
        expected = F.conv2d(xh, wh).double()
    else:
        expected = sum(F.conv2d(a.double(), b.double())
                       for a, b in ((xh, wh), (xh, wl), (xl, wh)))
    x.requires_grad_(True)
    got = ops.conv2d(x, w, padding='VALID', precision=precision)
    np.testing.assert_allclose(got.detach().double().numpy(), expected.numpy(), rtol=0,
                               atol=1e-6 * float(expected.abs().max()))
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), torch.autograd.grad(
        F.conv2d(x, wh + (wl if precision == 'high' else 0)).sum(), x)[0].numpy(), atol=1e-5)
    assert not torch.equal(got, F.conv2d(x, w))


@pytest.mark.parametrize('precision', ['high', 'default'])
def test_inet_precision_against_reference(precision):
    """The shipped INet at 'high' within 1e-4 of JAX's (float32 on the CPU),
    at 'default' within the operand rounding's ``DEFAULT_MAX`` and
    ``DEFAULT_MEAN``."""
    ref = jpipelines.INet(patch_size=PATCH, conv_precision=precision)
    ref.load_model(INET_DIR)
    port = pipelines.INet(patch_size=PATCH, conv_precision=precision, device='cpu')
    port.load_model(INET_DIR)
    x = np.random.default_rng(3).random((2, PATCH, PATCH, 4)).astype(np.float32)
    diff = np.abs(port.process(x).numpy() - np.asarray(ref.process(x)))
    if precision == 'high':
        assert diff.max() <= 1e-4
    else:
        assert diff.max() <= DEFAULT_MAX and diff.mean() <= DEFAULT_MEAN
        assert diff.max() > 0       # the rounding is there


# -- (b) the bfloat16 FAN -----------------------------------------------------------------------

def narrow_fans(dtype, stem, seed=7):
    ref = jforensics.FAN(n_classes=5, patch_size=32, dtype=dtype, stem=stem, **FAN_ARGS)
    weights = fan_weights(ref.params, seed)
    ref.params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in weights.items()},
                                              sep='/')
    port = forensics.FAN(n_classes=5, patch_size=32, dtype=dtype, stem=stem, device='cpu',
                         **FAN_ARGS)
    port.module.load_state_dict(base.convert_params(weights), strict=True)
    return ref, port, weights


def test_compose_conv_kernels_against_reference():
    """The fused stem's kernel (float32): within 1e-6 of its scale."""
    rng = np.random.default_rng(2)
    k1 = rng.standard_normal((5, 5, 3, 3)).astype(np.float32)
    k2 = rng.standard_normal((5, 5, 3, 8)).astype(np.float32)
    expected = np.asarray(jforensics.compose_conv_kernels(jnp.asarray(k1), jnp.asarray(k2)))
    got = forensics.compose_conv_kernels(torch.from_numpy(k1).permute(3, 2, 0, 1),
                                         torch.from_numpy(k2).permute(3, 2, 0, 1))
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), expected,
                               atol=1e-6 * np.abs(expected).max())


@pytest.mark.parametrize('stem', ['separate', 'fused'])
def test_bf16_fan_stem_within_one_ulp(stem):
    """The first layer's bfloat16 output (the constrained conv; for the fused
    stem the composed conv plus conv0's bias, before the activation) within
    one bfloat16 ulp of the reference's conv output, plus what float32
    summation in another order may move a sum of n terms: n · 2^-24 of the
    sum of their magnitudes, ``2^-16 · Σ|w x|`` for the 243 taps of the
    fused stem (a conv that cancels to near 0 differs by many of its own
    ulps, and the fused stem adds the bias to it after rounding); 99% of the
    values bit-equal."""
    ref, port, weights = narrow_fans('bfloat16', stem)
    x = rgb_batch()
    m = port.module
    variables = {'params': {'kernel': jnp.asarray(weights['constrained/kernel'])}}
    xp = ops.pad2d(nchw(x, BF16), 2, 'symmetric')
    if stem == 'separate':
        expected = jforensics.ConstrainedConv(dtype=jnp.bfloat16).apply(variables, jnp.asarray(x))
        scale = to_numpy(expected)
        got = m.constrained(nchw(x))
        kernel = m.constrained.normalized_kernel()
    else:
        nf = jforensics.ConstrainedConv(dtype=jnp.bfloat16).apply(variables, jnp.asarray(x),
                                                                  kernel_only=True)
        kc = jforensics.compose_conv_kernels(nf, jnp.asarray(weights['conv0/kernel']))
        xj = jops.pad2d(jops.pad2d(jnp.asarray(x, jnp.bfloat16), 2, 'symmetric'), 2, 'constant')
        h = jops.conv2d(xj, kc.astype(jnp.bfloat16), padding='VALID',
                        precision=jax.lax.Precision.DEFAULT)
        scale = to_numpy(h)
        expected = (h + jnp.asarray(weights['conv0/bias'])).astype(jnp.bfloat16)
        kernel = forensics.compose_conv_kernels(m.constrained.normalized_kernel(), m.conv0.weight)
        xp = ops.pad2d(xp, 2, 'constant')
        got = (ops.conv2d(xp, kernel, padding='VALID').float()
               + m.conv0.bias[:, None, None]).to(BF16)
    assert got.dtype == BF16
    expected, got = to_numpy(expected), nhwc(got)
    terms = nhwc(ops.conv2d(xp.float().abs(), kernel.detach().to(BF16).float().abs(),
                            padding='VALID'))
    bound = bf16_ulp(np.maximum(np.abs(scale), np.abs(expected))) + 2 ** -16 * terms
    assert np.all(np.abs(got - expected) <= bound)
    assert np.mean(got == expected) >= 0.99


@pytest.mark.parametrize('stem', ['separate', 'fused'])
def test_bf16_fan_probabilities(stem):
    ref, port, _ = narrow_fans('bfloat16', stem)
    x = rgb_batch()
    compare_probabilities(port.process(x), np.asarray(ref.process(x)))
    # the bfloat16 FAN is not the float32 one
    f32 = forensics.FAN(n_classes=5, patch_size=32, stem=stem, device='cpu', **FAN_ARGS)
    f32.module.load_state_dict(port.module.state_dict())
    assert not torch.equal(f32.process(x), port.process(x))


# -- (c) the bfloat16 plane-form JPEG, (d) the pools, and the manipulations ------------------

def flip_step(q_luma, q_chroma):
    """The most a reconstruction in [0, 1] moves when one coefficient rounds
    the other way: one q step times the largest 2-D DCT basis value (1/4),
    through the largest YCbCr → RGB coefficient, over 255."""
    return max(np.max(q_luma), np.max(q_chroma)) * 0.25 * 1.772 / 255.0


@pytest.mark.parametrize('quality', [50, 80])
def test_bf16_plane_jpeg_against_reference(quality):
    """bfloat16 at 'default' precision, against JAX's ``impl='planes'``: most
    values bit-equal (the share is reported), the mean |Δ| ≤ 1e-3 and the
    max no more than one flipped coefficient's step."""
    x = rgb_batch(3, 32)
    ql, qc = jpeg_qtable(quality, 0), jpeg_qtable(quality, 1)
    expected, coeffs_ref = jjpeg.jpeg_forward(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ql),
                                              jnp.asarray(qc), impl='planes',
                                              precision=jax.lax.Precision.DEFAULT)
    got, coeffs = pjpeg.jpeg_forward(torch.from_numpy(x).to(BF16), ql, qc, precision='default')
    assert got.dtype == BF16
    expected, got = to_numpy(expected), to_numpy(got)
    diff = np.abs(got - expected)
    print(f'bit-equal share {np.mean(diff == 0):.4f}, mean |d| {diff.mean():.3g}, '
          f'max {diff.max():.3g}')
    assert np.mean(diff == 0) >= 0.99
    assert diff.mean() <= 1e-3 and diff.max() <= flip_step(ql, qc)
    assert np.abs(to_numpy(coeffs) - to_numpy(coeffs_ref)).max() <= max(ql.max(), qc.max())


@pytest.mark.parametrize('precision', ['default', 'high'])
def test_float32_plane_jpeg_rounds_its_operands(precision):
    """A float32 batch at a matrix-unit precision takes the plane form with
    its operands rounded: close to the float32 codec (K1's plain version)
    but not equal to it."""
    x = torch.from_numpy(rgb_batch(2, 32))
    ql, qc = jpeg_qtable(50, 0), jpeg_qtable(50, 1)
    exact = pjpeg.jpeg_forward(x, ql, qc)[0]
    got = pjpeg.jpeg_forward(x, ql, qc, precision=precision)[0]
    assert got.dtype == torch.float32 and not torch.equal(got, exact)
    assert float((got - exact).abs().mean()) <= 1e-2


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('impl', ['flat', 'window'])
def test_pools_against_reference(dtype, impl):
    """``avg_pool_flat`` (two products, rounded after each in bfloat16) and
    ``avg_pool`` (bfloat16 summed tap by tap, as jax's ``reduce_window``)
    against the reference's: bit-equal, as every sum is exact or rounds
    the same way."""
    x = rgb_batch(2, 32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    pool = {'flat': (jops.avg_pool_flat, ops.avg_pool_flat),
            'window': (jops.avg_pool, ops.avg_pool)}[impl]
    got = pool[1](nchw(x, getattr(torch, dtype)), 2)
    assert got.dtype == getattr(torch, dtype)
    expected = to_numpy(pool[0](xj, 2))
    if dtype == 'float32' and impl == 'window':
        np.testing.assert_allclose(nhwc(got), expected, atol=1e-7)
    else:
        np.testing.assert_array_equal(nhwc(got), expected)


def test_flat_pool_falls_back_where_a_side_does_not_divide():
    x = torch.rand(1, 3, 6, 9, dtype=torch.float32)
    with pytest.raises(ValueError, match='not divisible'):
        ops.avg_pool_flat(x, 2)


CANDIDATES = [int(c) for c in np.linspace(40, 90, 8)]
BF16_MANIPULATIONS = {
    'sharpen': (lambda x: jmanips.sharpen(x, 1.0), lambda x: manips.sharpen(x, 1.0)),
    'sharpen_traced': (lambda x: jmanips.sharpen_traced(x, jnp.float32(0.7)),
                       lambda x: manips.sharpen_traced(x, torch.tensor(0.7))),
    'gaussian': (lambda x: jmanips.gaussian(x, 5, 0.83), lambda x: manips.gaussian(x, 5, 0.83)),
    'gaussian_traced': (lambda x: jmanips.gaussian_traced(x, jnp.float32(2.5)),
                        lambda x: manips.gaussian_traced(x, torch.tensor(2.5))),
    'resample': (lambda x: jmanips.resample(x, 50), lambda x: manips.resample(x, 50)),
    'resample_switch': (lambda x: jmanips.resample_switch(x, 5, CANDIDATES),
                        lambda x: manips.resample_switch(x, torch.tensor(5), CANDIDATES)),
    'jpeg_traced': (lambda x: jmanips.jpeg_traced(x, jnp.float32(70.0)),
                    lambda x: manips.jpeg_traced(x, torch.tensor(70.0))),
    'hsv_round_trip': (lambda x: jcolor.hsv_to_rgb(jcolor.rgb_to_hsv(x)),
                       lambda x: color.hsv_to_rgb(color.rgb_to_hsv(x))),
}


@pytest.mark.parametrize('name', list(BF16_MANIPULATIONS))
def test_bf16_manipulations_against_reference(name):
    """Each manipulation of a bfloat16 batch stays bfloat16, and at least
    99% of its values are bit-equal to the reference's; the rest lie within
    one ulp of the values before a later step (HSV's hue, a clip) moves them,
    so they are held in the mean (≤ 1e-4) and the max (≤ 2e-2)."""
    x = rgb_batch(3, 32)
    expected = to_numpy(BF16_MANIPULATIONS[name][0](jnp.asarray(x, jnp.bfloat16)))
    got = BF16_MANIPULATIONS[name][1](nchw(x, BF16))
    assert got.dtype == BF16
    diff = np.abs(nhwc(got) - expected)
    assert np.mean(diff == 0) >= 0.99 and diff.mean() <= 1e-4 and diff.max() <= 2e-2


@pytest.mark.parametrize('rounding', ['soft', 'sin', 'harmonic'])
def test_bf16_rounding_constants(rounding):
    """The roundings of a bfloat16 tensor take 2π (and kπ) rounded to
    bfloat16, as jax takes a weakly typed constant: bit-equal."""
    v = np.random.default_rng(4).standard_normal(20000).astype(np.float32) * 20
    expected = to_numpy(jquant.quantize(jnp.asarray(v, jnp.bfloat16), rounding, taylor_terms=5))
    got = quant.quantize(torch.from_numpy(v).to(BF16), rounding, taylor_terms=5)
    assert got.dtype == BF16
    np.testing.assert_array_equal(to_numpy(got), expected)


# -- (e) bench.py's configuration ---------------------------------------------------------------

def bench_flows(stem='separate'):
    """bench.py's flow in both packages (raw patch 16, the narrow bfloat16
    FAN with numpy-drawn weights, the m_quality run's INet)."""
    fan_args = {**FAN_ARGS, 'dtype': 'bfloat16', 'stem': stem}
    ref = JaxFlow('INet', fan_args=fan_args, **BENCH)
    weights = fan_weights(ref.fan.params)
    ref.fan.params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in weights.items()},
                                                  sep='/')
    ref.nip.load_model(os.path.join(RUN_DIR, 'models/inet'))
    ref.params = ref._collect_params()
    ref.opt_state = ref._tx.init(ref._train_partition(ref.params))
    port = ManipulationClassification('INet', fan_args=fan_args, device='cpu', **BENCH)
    port.fan.module.load_state_dict(base.convert_params(weights), strict=True)
    port.nip.load_model(os.path.join(RUN_DIR, 'models/inet'))
    port._snapshot()
    port.reinitialize()
    return ref, port


def camera_batches(seed):
    pairs = [jfixtures.make_raw_rgb_pair(2 * PATCH, 2 * PATCH, seed=seed + i)
             for i in range(BATCH)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def as_port_grads(tree):
    return {part: base.convert_params(flat_params(leaves)) for part, leaves in tree.items()}


def reference_step(ref, bx, by, lambda_nip):
    def loss_of(tparams, fparams, x, y, q_luma, q_chroma):
        return ref._losses({**fparams, **tparams}, x, y, jax.random.PRNGKey(0), q_luma,
                           q_chroma, lambda_nip, 0.0)
    q_luma, q_chroma = (jnp.asarray(q) for q in ref._channel_qtables())
    x, y = jops.normalize_batch(jnp.asarray(bx)), jops.normalize_batch(jnp.asarray(by))
    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        ref._train_partition(ref.params), ref._frozen_partition(ref.params), x, y, q_luma,
        q_chroma)
    return float(loss), {k: float(v) for k, v in parts.items()}, as_port_grads(grads)


def test_bench_configuration_builds_bf16_everywhere():
    """Every knob took effect: bfloat16 expansion, pool, channel and FAN
    input; no float32 codec on the path (K1 is never reached)."""
    _, port = bench_flows()
    bx, _ = camera_batches(30)
    with torch.no_grad():
        batch_Y, batch_c, batch_C, _, probs = port._forward(
            port._batch(bx).permute(0, 3, 1, 2), *port._channel_qtables())
    assert batch_Y.dtype == torch.float32 and probs.dtype == torch.float32
    assert batch_c.dtype == batch_C.dtype == BF16
    assert port.channel_precision == {'channel_dtype': 'bfloat16',
                                      'channel_jpeg_dtype': 'bfloat16',
                                      'manip_jpeg_dtype': 'bfloat16'}
    assert port.fan.module.compute_dtype == BF16 and port._pool_impl == 'flat'


@pytest.mark.parametrize('stem', ['separate', 'fused'])
def test_bench_configuration_forward(stem):
    """The developed RGB (float32) within 1e-5, the bfloat16 FAN input bit-equal
    in at least 99% of its values, and the probabilities by
    ``compare_probabilities``."""
    ref, port = bench_flows(stem)
    x = camera_batches(40)[0].astype(np.float32) / 65535.0
    expected, got = ref.run_workflow(x), port.run_workflow(x)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(expected[0]), atol=1e-5)
    assert got[2].dtype == BF16
    assert np.mean(to_numpy(got[2]) == to_numpy(expected[2])) >= 0.99
    compare_probabilities(got[-1], np.asarray(expected[-1]))


@pytest.mark.parametrize('stem', ['separate', 'fused'])
def test_bench_configuration_first_step(stem):
    """The first step's loss parts within ``BF16_STEP_LOSS_DIFF`` and the
    gradient norm of each trainable part within ``BF16_GRADIENT_NORM_DIFF``
    (relative). A leaf's norm alone may part further: the reference on the
    CPU sums a bfloat16 bias's gradient over the batch and the positions in
    bfloat16, the port in float32; each weight leaf is held to the bound."""
    ref, port = bench_flows(stem)
    bx, by = camera_batches(50)
    step_ref = reference_step(ref, bx, by, 0.1)
    step = port.loss_and_gradients(bx, by, 0.1)
    for name, value in [('loss', step_ref[0])] + list(step_ref[1].items()):
        got = step[0] if name == 'loss' else step[1][name]
        assert abs(float(got) - value) <= BF16_STEP_LOSS_DIFF * abs(value), name

    def norm(leaves):
        return float(sum(torch.sum(g.double() ** 2) for g in leaves.values())) ** 0.5

    for part, leaves in step_ref[2].items():
        assert abs(norm(step[2][part]) - norm(leaves)) <= BF16_GRADIENT_NORM_DIFF * norm(leaves)
        for name, g in leaves.items():
            if not name.endswith('bias') or part == 'nip':
                a, b = float(step[2][part][name].norm()), float(g.norm())
                assert abs(a - b) <= BF16_GRADIENT_NORM_DIFF * b, f'{part}/{name}'


def test_bench_configuration_two_adam_steps():
    """Two Adam steps in each package from the same weights and batches: the
    loss parts within ``BF16_STEP_LOSS_DIFF``; every parameter within 2·lr
    a step of the reference's (Adam's first steps move each entry by about
    lr·sign(g)), and every entry of the NIP, whose gradients are float32 in
    both, within 1e-6 where its first gradient is above 1e-2 of its leaf's
    scale."""
    ref, port = bench_flows()
    before = {part: {k: p.detach().clone() for k, p in leaves.items()}
              for part, leaves in port._collect_params().items()}
    first = port.loss_and_gradients(*camera_batches(60), 0.1)[2]
    for step in range(STEPS):
        bx, by = camera_batches(60 + 10 * step)
        ref_loss, ref_parts = ref.training_step(bx, by, 0.1, learning_rate=LR)
        loss, parts = port.training_step(bx, by, 0.1, learning_rate=LR)
        for name, value in ref_parts.items():
            assert abs(float(parts[name]) - float(value)) <= BF16_STEP_LOSS_DIFF * abs(
                float(value)), name
    after_ref = as_port_grads(ref._train_partition(ref.params))
    after = port._train_partition(port._collect_params())
    for part, leaves in after_ref.items():
        for name, p_ref in leaves.items():
            p = after[part][name].detach()
            diff = (p - p_ref).abs()
            assert float(diff.max()) <= 2 * LR * STEPS + 1e-6, f'{part}/{name}'
            assert float((p - before[part][name]).abs().max()) > 0.5 * LR, f'{part}/{name}'
            if part == 'nip':
                g = first[part][name]
                clear = g.abs() > 1e-2 * g.abs().max()
                assert float(diff[clear].max()) <= 1e-6, f'{part}/{name}'


# -- (f) the shipped runs, restored ---------------------------------------------------------------

def restore_args(patch=PATCH):
    return argparse.Namespace(jpeg=None, codec=None, dcn=None, ds=None, manip=None, patch=patch,
                              channel_dtype=None, channel_jpeg_dtype=None, manip_jpeg_dtype=None)


@pytest.mark.parametrize('run', list(SHIPPED))
def test_restore_shipped_run_as_the_reference(run):
    """``restore`` rebuilds the channel precision and the FAN that
    ``test_fan.restore_flow`` rebuilds (the log's channel precision, float32
    where it records none, as for ``m_fan_bf16``; the FAN's arguments) and
    the INet the log records (the reference's ``restore_flow`` passes no
    NIP arguments and so builds INet at 'exact'). The INet is held to the
    JAX INet at the log's precision, within the bounds of
    ``test_inet_precision_against_reference``; then the same developed RGB
    goes through both packages' manipulations, channel and FAN, held by
    ``compare_probabilities``."""
    with open(os.path.join(SHIPPED[run], 'training.json')) as f:
        log = json.load(f)
    ref, _ = test_fan.restore_flow(os.path.join(SHIPPED[run], 'training.json'), restore_args())
    port = ManipulationClassification.restore(SHIPPED[run], PATCH, device='cpu')
    assert port.channel_precision == {
        'channel_dtype': 'bfloat16' if ref._channel_dtype == jnp.bfloat16 else 'float32',
        'channel_jpeg_dtype': 'bfloat16' if ref._channel_jpeg_bf16 else 'float32',
        'manip_jpeg_dtype': 'bfloat16' if ref._manip_jpeg_bf16 else 'float32'}
    assert port._manip_jpeg_bf16 == (run == 'm_manipjpeg_bf16')
    assert port.fan._h.to_json() == ref.fan._h.to_json()
    assert port.fan._h.dtype == 'float32'
    assert port.nip._h.to_json() == log['nip']['args']

    inet = jpipelines.INet(patch_size=PATCH, **log['nip']['args'])
    inet.load_model(os.path.join(SHIPPED[run], 'models'))
    x = camera_batches(70)[0].astype(np.float32) / 65535.0
    diff = np.abs(port.nip.process(x).numpy() - np.asarray(inet.process(x)))
    assert diff.max() <= (1e-4 if log['nip']['args']['conv_precision'] == 'high'
                          else DEFAULT_MAX)
    batch_Y = np.asarray(ref.run_workflow(x)[0])
    compare_probabilities(port.run_rgb_to_probabilities(batch_Y),
                          ref.run_rgb_to_probabilities(batch_Y))


def test_restore_takes_the_reference_overrides():
    """The dtype overrides of ``test_fan.py`` as keyword arguments, and an
    unknown dtype refused as the reference refuses it."""
    port = ManipulationClassification.restore(SHIPPED['m_fan_bf16'], PATCH,
                                              channel_dtype='bfloat16',
                                              channel_jpeg_dtype='bfloat16', device='cpu')
    assert port.channel_precision == {'channel_dtype': 'bfloat16',
                                      'channel_jpeg_dtype': 'bfloat16',
                                      'manip_jpeg_dtype': 'float32'}
    with pytest.raises(ValueError, match='channel dtype'):
        ManipulationClassification.restore(SHIPPED['m_fan_bf16'], PATCH,
                                           channel_dtype='float16', device='cpu')


# -- (g) a bfloat16 trainer run, restored in both packages ------------------------------------

def test_bf16_trainer_run_restores_in_both_packages(tmp_path):
    """The port's CLI with every bfloat16 flag and a fused bfloat16 FAN
    writes the run's channel precision and the FAN's dtype and stem; both
    packages restore the run with them and classify its validation set as
    logged (the port exactly; the reference to within the rows whose two
    top classes lie within ``DECISION_MARGIN``)."""
    data_dir = jfixtures.make_dataset(str(tmp_path / 'data'), n_images=6, height=64, width=96,
                                      seed=500)
    fan = {'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0, 'dtype': 'bfloat16',
           'stem': 'fused'}
    cli.main(['--nip', 'INet', '--cam', 'SyntheticCam', '--data', data_dir, '--split', '4:2:2',
              '--epochs', '2', '--patch', str(PATCH), '--batch', str(BATCH),
              '--val-schedule', '1', '--fan', json.dumps(fan), '--dir', str(tmp_path / 'm'),
              '--nip-dir', NIP_DIR, '--device', 'cpu', '--train', 'nip', '--jpeg', '50',
              '--channel-dtype', 'bfloat16', '--channel-jpeg-dtype', 'bfloat16',
              '--manip-jpeg-dtype', 'bfloat16'])
    run_dir = tmp_path / 'm/SyntheticCam/INet/ln-0.1000/fixed-codec/000'
    log = json.loads((run_dir / 'training.json').read_text())
    assert log['channel_precision'] == {'channel_dtype': 'bfloat16',
                                        'channel_jpeg_dtype': 'bfloat16',
                                        'manip_jpeg_dtype': 'bfloat16'}
    assert log['forensics']['args']['dtype'] == 'bfloat16'
    assert log['forensics']['args']['stem'] == 'fused'
    logged = log['forensics']['performance']['accuracy']['validation'][-1]
    split = dict(n_images=4, v_images=2, val_rgb_patch_size=2 * PATCH, val_n_patches=2)

    port = ManipulationClassification.restore(str(run_dir), PATCH, device='cpu')
    assert port.channel_precision == log['channel_precision']
    assert port.fan.module.compute_dtype == BF16 and port.fan.module.stem == 'fused'
    accuracy, _ = validation.validate_fan(port, Dataset(data_dir, **split))
    assert accuracy == logged

    ref, expected = test_fan.restore_flow(str(run_dir / 'training.json'), restore_args())
    assert ref._channel_dtype == jnp.bfloat16 and ref._channel_jpeg_bf16 and ref._manip_jpeg_bf16
    assert ref.fan._h.dtype == 'bfloat16' and ref.fan._h.stem == 'fused'
    data = JaxDataset(data_dir, **split)
    accuracy_ref, _ = jvalidation.validate_fan(ref, data)
    x, _ = data.next_validation_batch(0, data.count_validation)
    probs = np.concatenate([np.asarray(ref.run_workflow(x[i:i + 10])[-1])
                            for i in range(0, data.count_validation, 10)])
    top2 = np.sort(probs, axis=1)[:, -2:]
    ties = int(np.sum(top2[:, 1] - top2[:, 0] <= DECISION_MARGIN))
    assert round(abs(accuracy_ref - expected) * len(probs)) <= ties
