"""The port's numpy counterparts of ``jax.random`` and of flax's key
derivation (``utils/prng.py``) against jax and flax on the CPU, and the
port's models initialized from a seed (the FAN, the camera ISPs, the DCN)
against the JAX package's from ``PRNGKey(seed)``.

Keys, ``fold_in`` and random bits are exact, as is ``uniform`` (its
multiply-add rounded once, as XLA's CPU code fuses it). The inverse error
function differs from XLA's by at most ``ERFINV_ULPS`` ulps (XLA's own
float32 ``log1p``; numpy's rounds otherwise in ~1.5% of values), so the
truncated normal draws and the models' initial weights agree within
``WEIGHT_ULPS`` ulps, ~98% of them bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from neural_imaging_tpu.models import compression as jcompression
from neural_imaging_tpu.models import forensics as jforensics
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu_torch.models import base, compression, forensics, pipelines
from neural_imaging_tpu_torch.utils import prng

ERFINV_ULPS, WEIGHT_ULPS = 2, 4


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize('seed', [0, 1, 29, 1234, 2 ** 31 - 1, -5])
def test_prng_key_and_fold_in_are_jax_s(seed):
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))
    for data in (0, 1, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data),
                                      np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                                    data)))


@pytest.mark.parametrize('seed', [0, 1, 29, -5])
@pytest.mark.parametrize('num', [1, 2, 3])
def test_split_is_jax_s(seed, num):
    ref = jax.random.split(jax.random.PRNGKey(seed), num)
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed), num),
                                  np.asarray(jax.random.key_data(ref)))


def test_prng_key_refuses_a_seed_outside_int32():
    with pytest.raises(ValueError, match='int32'):
        prng.prng_key(2 ** 31)


@pytest.mark.parametrize('n', [1, 2, 7, 4096])
def test_random_bits_are_jax_s(n):
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(prng.random_bits32(prng.prng_key(7), n),
                                  np.asarray(jax.random.bits(key, (n,), jnp.uint32)))


@pytest.mark.parametrize('bounds', [(0.0, 1.0), (-0.9544997, 0.9544997), (-3.0, 5.0)])
def test_uniform_is_jax_s(bounds):
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.uniform(key, (6, 50), jnp.float32, *bounds))
    np.testing.assert_array_equal(prng.uniform(prng.prng_key(11), (6, 50), *bounds), ref)


def test_erfinv_is_xla_s():
    x = np.linspace(-0.9999, 0.9999, 20001, dtype=np.float32)
    d = ulps(prng.erfinv32(x), jax.lax.erf_inv(jnp.asarray(x)))
    assert d.max() <= ERFINV_ULPS and (d == 0).mean() > 0.95
    assert np.isinf(prng.erfinv32(np.float32([-1, 1]))).all()


@pytest.mark.parametrize('shape', [(5, 5, 3, 16), (1000,)])
def test_truncated_normal_is_jax_s(shape):
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.random.truncated_normal(key, -2, 2, shape, jnp.float32))
    out = prng.truncated_normal(prng.prng_key(3), -2, 2, shape)
    assert out.shape == ref.shape and out.dtype == np.float32
    d = ulps(out, ref)
    assert d.max() <= WEIGHT_ULPS and (d == 0).mean() > 0.95
    assert np.abs(out).max() < 2


@pytest.mark.parametrize('fan_args', [
    {'n_classes': 3, 'patch_size': 64, 'n_convolutions': 2, 'n_filters': 16, 'n_dense': 1},
    {'n_classes': 5, 'patch_size': 128},
    {'n_classes': 3, 'patch_size': 32, 'n_convolutions': 2, 'n_filters': 8, 'n_dense': 2,
     'use_gap': False},
    {'n_classes': 3, 'patch_size': 64, 'n_convolutions': 2, 'n_filters': 16, 'n_dense': 1,
     'dtype': 'bfloat16'}], ids=['framework', 'default', 'flatten', 'bf16'])
@pytest.mark.parametrize('seed', [0, 3])
def test_fan_initial_weights_are_the_reference_s(fan_args, seed):
    ref = jforensics.FAN(**fan_args)
    if seed:
        ref._init_params(seed)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(ref.params, sep='/').items()}
    expected = base.convert_params(flat)
    port = forensics.FAN(device='cpu', seed=seed, **fan_args).module.state_dict()
    assert port.keys() == expected.keys()
    for name, value in expected.items():
        value = np.asarray(value)
        assert port[name].shape == value.shape, name
        assert ulps(port[name].numpy(), value).max() <= WEIGHT_ULPS, name


def assert_initial_weights_match(port_module, ref_params):
    """Every parameter and buffer of the port's state equals the JAX
    model's initial value of that name within ``WEIGHT_ULPS``."""
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(ref_params, sep='/').items()}
    expected = base.convert_params(flat, base.transposed_kernels(port_module))
    port = {k: v for k, v in port_module.state_dict().items()}
    assert port.keys() == expected.keys()
    for name, value in expected.items():
        assert port[name].shape == value.shape, name
        assert ulps(port[name].numpy(), value.numpy()).max() <= WEIGHT_ULPS, name


@pytest.mark.parametrize('name, kwargs', [
    ('UNet', {'n_steps': 3}), ('UNet', {}), ('DNet', {'n_layers': 3, 'n_features': 8}),
    ('ClassicISP', {'c_filters': (8, 8)}),
    ('ClassicISP', {'c_filters': (8,), 'residual': False}), ('ClassicISP', {})],
    ids=['unet3', 'unet5', 'dnet', 'classic_residual', 'classic_direct', 'classic_bilinear'])
def test_isp_initial_weights_are_the_reference_s(name, kwargs):
    ref = getattr(jpipelines, name)(patch_size=32, **kwargs)
    port = getattr(pipelines, name)(patch_size=32, device='cpu', **kwargs)
    assert_initial_weights_match(port.module, ref.params)


@pytest.mark.parametrize('kwargs', [{'n_features': 32}, {'n_features': 8, 'train_codebook': True}],
                         ids=['framework', 'trainable'])
def test_dcn_initial_weights_are_the_reference_s(kwargs):
    ref = jcompression.TwitterDCN(patch_size=32, **kwargs)
    port = compression.TwitterDCN(patch_size=32, device='cpu', **kwargs)
    assert_initial_weights_match(port.module, ref.params)
