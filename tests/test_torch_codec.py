"""Parity of the port's DCN bitstream (``compression/codec.py``) and its rANS
binding (``compression/entropy.py``) with the JAX package on the CPU: the
same bytes for the same input, and exact round trips. Bytes are compared
for equality; the decoded images of the shipped codecs (32c, and 8c, 16c,
64c at two sizes) within 1e-5 (float32 convolutions summed in another
order)."""
import numpy as np
import pytest
import torch

from neural_imaging_tpu.compression import codec as jcodec
from neural_imaging_tpu.compression import entropy as jentropy
from neural_imaging_tpu.ops import quantization as jquant
from neural_imaging_tpu_torch.compression import codec, entropy

torch.set_num_threads(1)

CODEBOOK = jquant.default_codebook(5)


def byte_streams():
    rng = np.random.default_rng(0)
    skewed = np.minimum(rng.geometric(0.3, 5000), 40).astype(np.uint8)
    return {'skewed': skewed.tobytes(), 'repeated': bytes([7]) * 300,
            'uniform': rng.integers(0, 256, 200).astype(np.uint8).tobytes(),
            'two symbols': bytes([0, 1]) * 50 + bytes([0]) * 400}


@pytest.mark.parametrize('name', list(byte_streams()))
def test_entropy_coder_matches_the_jax_packages(name):
    data = byte_streams()[name]
    outcomes = []
    for module in (jentropy, entropy):
        try:
            outcomes.append(module.compress(data))
        except module.ANSException as e:
            outcomes.append(type(e).__name__)
    assert outcomes[0] == outcomes[1]
    if isinstance(outcomes[1], bytes):
        assert entropy.decompress(outcomes[1], len(data)) == data


def test_entropy_library_is_built_from_the_source_without_host_tuning():
    assert '-march=native' not in entropy.CXX_FLAGS
    path = entropy.build()
    assert path == entropy.library_path() and path.exists()
    assert path.parent.name == '_build' and path.name.startswith('libans-')
    with pytest.raises(entropy.ANSCorruptStreamError):
        entropy.decompress(b'\x01\x00')
    with pytest.raises(ValueError):
        entropy.compress(b'')


class LatentModel:
    """Stands in for a DCN whose encoder returns a given NHWC latent and whose
    decoder returns its input, so a round trip shows the decoded latent."""

    def __init__(self, latent, as_tensor):
        self.latent, self.as_tensor = latent, as_tensor
        self.latent_shape = (None, None, latent.shape[-1])

    def get_codebook(self):
        return CODEBOOK

    def compress(self, batch_x):
        return torch.from_numpy(self.latent) if self.as_tensor else self.latent

    def decompress(self, batch_z):
        return torch.from_numpy(np.asarray(batch_z)) if self.as_tensor else batch_z


def latent_with_every_layer_kind(seed, h=8, w=12):
    """Feature maps that code as rANS (skewed), RLE (constant) and raw
    (uniform over 32 codewords: the frequency table outgrows 96 bytes)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.minimum(rng.geometric(0.5, (h, w)) - 1, 31),
                    np.full((h, w), 17),
                    rng.integers(0, 32, (h, w)),
                    np.minimum(rng.geometric(0.2, (h, w)), 31)], axis=-1)
    return CODEBOOK[idx][None].astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1])
def test_bitstream_bytes_equal_the_jax_packages_and_round_trip(seed):
    z = latent_with_every_layer_kind(seed)
    x = np.zeros((1, 64, 96, 3), np.float32)
    blob = codec.compress(x, LatentModel(z, True))
    assert blob == jcodec.compress(x, LatentModel(z, False))
    np.testing.assert_array_equal(codec.decompress(blob, LatentModel(z, True)), z)
    np.testing.assert_array_equal(jcodec.decompress(blob, LatentModel(z, False)), z)
    assert codec.coded_bytes(torch.from_numpy(z), CODEBOOK) == int(
        jcodec.coded_bytes_callback(CODEBOOK)(z))


def test_bitstream_refuses_latents_the_header_cannot_hold():
    z = np.zeros((1, 256, 1, 2), np.float32)
    with pytest.raises(codec.L3ICError, match='header'):
        codec.compress(np.zeros((1, 8, 8, 3)), LatentModel(z, True))
    with pytest.raises(codec.L3ICError, match='1x3'):
        codec.compress(np.zeros((1, 8, 8, 3)), LatentModel(np.zeros((1, 1, 3, 2), np.float32),
                                                           True))


@pytest.fixture(scope='module')
def pair():
    return jcodec.restore('32c'), codec.restore('32c', device='cpu')


def test_shipped_codec_bytes_and_images_equal_the_jax_packages(pair):
    ref, port = pair
    x = np.random.default_rng(5).random((1, 64, 96, 3)).astype(np.float32)
    blob = codec.compress(x, port)
    assert blob == jcodec.compress(x, ref)
    y = codec.decompress(blob, port)
    np.testing.assert_allclose(y, np.asarray(jcodec.decompress(blob, ref)), atol=1e-5)
    # without a model the stream's preset is restored on the requested device
    np.testing.assert_allclose(codec.decompress(blob, device='cpu'), y, atol=0)
    # the direct latent is the straight-through value (hard − soft) + soft, a
    # float32 ulp or so off the codeword that the bitstream carries
    direct, coded = codec.compare(port, x)
    np.testing.assert_allclose(direct, coded, atol=1e-5)
    image, n_bytes = codec.simulate_compression(x, port)
    assert n_bytes == len(blob)
    np.testing.assert_array_equal(image, y)


_PRESETS = {}


def preset_pair(preset):
    if preset not in _PRESETS:
        _PRESETS[preset] = jcodec.restore(preset), codec.restore(preset, device='cpu')
    return _PRESETS[preset]


@pytest.mark.parametrize('h,w', [(64, 96), (128, 192)])
@pytest.mark.parametrize('preset', ['8c', '16c', '64c'])
def test_other_shipped_codecs_bytes_and_images_equal_the_jax_packages(preset, h, w):
    """The 8c, 16c and 64c codecs as the 32c one above: the same bytes for
    one image, and its decode within 1e-5."""
    ref, port = preset_pair(preset)
    assert port.latent_shape[-1] == int(preset[:-1]) and port.model_code == ref.model_code
    x = np.random.default_rng(h + int(preset[:-1])).random((1, h, w, 3)).astype(np.float32)
    blob = codec.compress(x, port)
    assert blob == jcodec.compress(x, ref)
    np.testing.assert_allclose(codec.decompress(blob, port),
                               np.asarray(jcodec.decompress(blob, ref)), atol=1e-5)
