"""
The DCN image codec: a quantized latent serialized to a real bitstream and
back. Port of ``neural_imaging_tpu/compression/codec.py``, in its byte
format:

  - 3 x uint8           latent shape (H, W, N), so each side is at most 255
  - uint16              length of the coded layer-size block
  - coded layer sizes   entropy-coded uint16 array (or its raw bytes)
  - per feature map     entropy-coded uint8 codebook indices, or a 3-byte RLE
                        record (uint16 count + uint8 value), or raw indices

The DCN's encoder and decoder run on the model's device; vector quantization
against the codebook and entropy coding run on the host.
"""
import io
import logging

import numpy as np

from neural_imaging_tpu_torch.compression import entropy
from neural_imaging_tpu_torch.models import base, compression
from neural_imaging_tpu_torch.utils import metrics, stats

log = logging.getLogger(__name__)


class L3ICError(Exception):
    pass


def _vq(values, code_book):
    """Nearest-codeword index of every value (host): uint8."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    code_book = np.asarray(code_book, dtype=np.float64).reshape(-1)
    return np.argmin(np.abs(values[:, None] - code_book[None, :]), axis=1).astype(np.uint8)


def _code_layer(indices):
    """One feature map's bytes: rANS, else an RLE record or the raw indices."""
    try:
        return entropy.compress(indices.tobytes())
    except entropy.ANSSymbolRepetitionError:
        return np.uint16(len(indices)).tobytes() + np.uint8(indices[0]).tobytes()
    except entropy.ANSNotCompressibleError:
        return indices.tobytes()


def _latent(model, batch_x):
    return model.compress(batch_x).cpu().numpy()


def compress(batch_x, model):
    """Encode one NHWC image (through ``model.compress``) into a
    self-contained bitstream (bytes)."""
    batch_x = np.asarray(batch_x)
    if batch_x.ndim == 3:
        batch_x = batch_x[None]
    if batch_x.ndim != 4 or batch_x.shape[0] != 1:
        raise ValueError(f'codec.compress takes one image, got shape {batch_x.shape}')

    batch_z = _latent(model, batch_x)
    if max(batch_z.shape[1:]) > 255:
        raise L3ICError(f'latent {batch_z.shape[1:]} does not fit the 3 x uint8 header')
    latent_shape = np.array(batch_z.shape[1:], dtype=np.uint8)

    code_book = model.get_codebook()
    if len(code_book) > 256:
        raise L3ICError('Code-books with more than 256 centers are not supported')
    if int(latent_shape[0]) * int(latent_shape[1]) == 3:
        # a 3-byte raw layer would be indistinguishable from an RLE record
        raise L3ICError('1x3 / 3x1 latent planes are not representable in the bitstream')

    coded_layers = []
    for n in range(latent_shape[-1]):
        coded = _code_layer(_vq(batch_z[0, :, :, n], code_book))
        if len(coded) == 1:
            raise L3ICError(f'Layer {n} compresses to a single byte - something is wrong!')
        coded_layers.append(coded)

    layer_lengths = np.array([len(c) for c in coded_layers], dtype=np.uint16)
    try:
        coded_lengths = entropy.compress(layer_lengths.tobytes())
    except (entropy.ANSNotCompressibleError, entropy.ANSSymbolRepetitionError):
        coded_lengths = layer_lengths.tobytes()

    stream = io.BytesIO()
    stream.write(latent_shape.tobytes())
    stream.write(np.uint16(len(coded_lengths)).tobytes())
    stream.write(coded_lengths)
    for layer in coded_layers:
        stream.write(layer)
    return stream.getvalue()


def decompress(stream, model=None, device='cuda'):
    """Decode a bitstream of :func:`compress` to an NHWC RGB image (numpy).
    Without a ``model``, or with one whose latent depth differs from the
    stream's, the matching preset (``'<N>c'``) is restored on ``device``."""
    if isinstance(stream, bytes):
        stream = io.BytesIO(stream)
    elif not hasattr(stream, 'read'):
        raise ValueError('Unsupported stream type!')

    latent_x, latent_y, n_latent = (int(v) for v in np.frombuffer(stream.read(3), np.uint8))
    layer_bytes = int(np.frombuffer(stream.read(2), np.uint16)[0])
    coded_layer_lengths = stream.read(layer_bytes)
    if layer_bytes != 2 * n_latent:
        layer_lengths = np.frombuffer(entropy.decompress(coded_layer_lengths, 2 * n_latent),
                                      dtype=np.uint16)
    else:
        layer_lengths = np.frombuffer(coded_layer_lengths, dtype=np.uint16)

    if model is None:
        model = restore(f'{n_latent}c', device=device)
    elif model.latent_shape[-1] != n_latent:
        log.warning('decoder model (%dc) does not match the coded stream (%dc) - switching',
                    model.latent_shape[-1], n_latent)
        model = restore(f'{n_latent}c', device=model.device)

    code_book = model.get_codebook()
    batch_z = np.zeros((1, latent_x, latent_y, n_latent), dtype=np.float32)
    plane = latent_x * latent_y
    for n in range(n_latent):
        coded = stream.read(int(layer_lengths[n]))
        try:
            # a 3-byte layer can only be an RLE record: a rANS stream is never
            # shorter than its header of 4 (length) + 1 (symbol count) + 3 per
            # symbol >= 8 bytes, and the encoder refuses plane == 3
            if len(coded) == 3 and plane != 3:
                count = int(np.frombuffer(coded[:2], dtype=np.uint16)[0])
                layer_data = coded[-1:] * count
            elif len(coded) == plane:
                layer_data = coded
            else:
                layer_data = entropy.decompress(coded, plane)
        except entropy.ANSException as e:
            raise L3ICError(f'Error while decoding layer {n} '
                            f'(stream of {len(coded)} bytes)') from e
        batch_z[0, :, :, n] = code_book[np.frombuffer(layer_data, np.uint8)] \
            .reshape(latent_x, latent_y)

    return model.decompress(batch_z).cpu().numpy()


def compare(dcn, batch_x):
    """The direct decode (latent straight into the decoder) and the decode
    of the latent after entropy coding, which must be lossless: raises
    AssertionError if the decoded indices differ. Returns (direct_decode,
    bitstream_decode), numpy."""
    batch_z = _latent(dcn, batch_x)
    batch_y = dcn.decompress(batch_z).cpu().numpy()
    code_book = dcn.get_codebook()
    indices = _vq(batch_z, code_book)
    decoded = entropy.decompress(entropy.compress(indices.tobytes()), indices.size)
    if indices.tobytes() != decoded:
        raise AssertionError('Entropy decoding error')
    recovered = code_book[np.frombuffer(decoded, np.uint8)].reshape(batch_z.shape)
    image_y = dcn.decompress(recovered.astype(np.float32)).cpu().numpy()
    return batch_y, image_y


def simulate_compression(batch_x, dcn):
    """Full round trip through the real bitstream; returns (image, n_bytes)."""
    blob = compress(batch_x, dcn)
    return decompress(blob, dcn), len(blob)


def compress_n_stats(batch_x, dcn):
    """Each image of an NHWC batch through the real bitstream: (decoded
    batch, {'ssim', 'psnr', 'entropy', 'bytes', 'bpp'}), the statistics per
    image (numpy arrays; numbers for a batch of one)."""
    batch_x = np.asarray(batch_x)
    batch_y = np.zeros_like(batch_x)
    out = {k: np.zeros(batch_x.shape[0]) for k in ('ssim', 'psnr', 'entropy', 'bytes', 'bpp')}
    for i in range(batch_x.shape[0]):
        recon, n_bytes = simulate_compression(batch_x[i:i + 1], dcn)
        batch_y[i] = recon[0]
        out['bytes'][i] = n_bytes
        out['entropy'][i] = stats.entropy(_latent(dcn, batch_x[i:i + 1]), dcn.get_codebook())
        out['ssim'][i] = metrics.ssim(batch_x[i], batch_y[i])
        out['psnr'][i] = metrics.psnr(batch_x[i], batch_y[i])
        out['bpp'][i] = 8 * n_bytes / (batch_x.shape[1] * batch_x.shape[2])
    if batch_x.shape[0] == 1:
        out = {k: v[0] for k, v in out.items()}
    return batch_y, out


def global_compress(dcn, batch_x):
    """The whole latent of ``batch_x`` coded as one rANS stream of codeword
    indices (no header, no per-feature-map fallbacks)."""
    return entropy.compress(_vq(_latent(dcn, batch_x), dcn.get_codebook()).tobytes())


def coded_bytes(latent, code_book):
    """Coded size in bytes of an NHWC latent (numpy or tensor) with the
    bitstream's per-feature-map coding (rANS, RLE or raw), headers not
    counted: the real rate of a latent."""
    latent = np.asarray(latent.cpu() if hasattr(latent, 'cpu') else latent)
    return sum(len(_code_layer(_vq(latent[..., n], code_book)))
               for n in range(latent.shape[-1]))


def restore(dir_name, patch_size=None, device='cuda'):
    """Preset-aware DCN restore, e.g. ``codec.restore('16c')`` (presets in
    ``config/presets/compression.json``)."""
    return base.restore(dir_name, compression, patch_size=patch_size, device=device)
