"""Tests of the port's CUDA kernels that need the card. They skip without
one; on a GPU machine, which has no JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The kernel is held against its plain PyTorch version on the same inputs,
with the tolerance of ``jpeg8x8.check_cores``."""
import numpy as np
import pytest
import torch

from neural_imaging_tpu_torch.compression.jpeg_helpers import jpeg_qtable
from neural_imaging_tpu_torch.ops.hopper import jpeg8x8

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def inputs(seed, p, h, w, quality, device):
    rng = np.random.default_rng(seed)
    planes = (rng.random((p, h, w)) * 255 - 127).astype(np.float32)
    q = np.stack([jpeg_qtable(quality, 0), jpeg_qtable(quality, 1), jpeg_qtable(quality, 1)])
    q = np.tile(q, (p // 3, 1, 1))
    return torch.from_numpy(planes).to(device), torch.from_numpy(q).to(device)


# widths that fill, split and fall short of the kernel's 128-column tiles
@pytest.mark.parametrize('p,h,w', [(3, 8, 8), (3, 16, 24), (6, 16, 136), (3, 24, 256),
                                   (60, 256, 256), (300, 128, 128)])
def test_kernel_matches_plain(cuda, p, h, w):
    planes, q = inputs(p * h + w, p, h, w, 50, cuda)
    before = jpeg8x8.jpeg_core_cuda.launches
    y, c = jpeg8x8.jpeg_core_cuda(planes, q)
    y_p, c_p = jpeg8x8.jpeg_core_plain(planes, q)
    torch.cuda.synchronize()
    assert jpeg8x8.jpeg_core_cuda.launches == before + 1
    jpeg8x8.check_cores(y, c, y_p, c_p, q)


def test_dispatch_and_backward_on_the_card(cuda):
    planes, q = inputs(1, 3, 16, 16, 80, cuda)
    planes.requires_grad_()
    before = jpeg8x8.jpeg_core_cuda.launches
    y, c = jpeg8x8.jpeg_core(planes, q)
    (y.sum() + c.sum()).backward()
    assert jpeg8x8.jpeg_core_cuda.launches == before + 1
    g_ref, _ = jpeg8x8.jpeg_core_backward(planes.detach(), q, torch.ones_like(y),
                                          torch.ones_like(c))
    torch.testing.assert_close(planes.grad, g_ref)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    planes, q = inputs(2, 3, 16, 16, 50, cuda)
    with pytest.raises(ValueError, match='contiguous'):
        jpeg8x8.jpeg_core_cuda(planes.transpose(1, 2), q)
    with pytest.raises(ValueError, match='one CUDA device'):
        jpeg8x8.jpeg_core_cuda(planes, q.cpu())
