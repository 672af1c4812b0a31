"""Tests of the port's CUDA kernels that need the card. They skip without
one; on a GPU machine, which has no JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same inputs,
with the tolerance of ``jpeg8x8.check_cores`` (K1) and of
``codebook.check_forward`` / ``codebook.check_backward`` (K2-K4)."""
import os

import numpy as np
import pytest
import torch

from neural_imaging_tpu_torch.compression.jpeg_helpers import jpeg_qtable
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.ops.hopper import codebook, jpeg8x8

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


def codebook_inputs(seed, n, bpf, device, offset=0.0):
    rng = np.random.default_rng(seed)
    cb = quant.default_codebook(bpf) + offset
    arrays = (rng.standard_normal(n) * 2 ** (bpf - 2), rng.standard_normal(n), cb,
              rng.standard_normal(cb.size))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


# ragged N (1, 255, 777), the DCN's training and serving latents, the DCN
# channel's latent in the joint flow (m_quality_dcn: 50 x 16 x 16 x 32), and
# Ns past the grid cap (1024 blocks of 256) that exercise the grid-stride
# loop; L from 16 to 256 codewords
@pytest.mark.parametrize('n,bpf', [(1, 5), (255, 5), (777, 4), (131072, 5), (196608, 5),
                                   (300001, 8), (409600, 5)])
@pytest.mark.parametrize('v,gamma', [(50.0, 25.0), (0.0, 5.0)])
def test_codebook_kernels_match_plain(cuda, n, bpf, v, gamma):
    z, g, cb, pc = codebook_inputs(n + bpf, n, bpf, cuda, offset=0.05)
    counts = [f.launches for f in (codebook.codebook_fwd_cuda, codebook.codebook_bwd_cuda,
                                   codebook.codebook_bwd_train_cuda)]
    soft, hard = codebook.codebook_fwd_cuda(z, cb, v, gamma)
    dz3 = codebook.codebook_bwd_cuda(z, g, cb, pc, v, gamma)
    dz4, dcb = codebook.codebook_bwd_train_cuda(z, g, cb, pc, v, gamma)
    torch.cuda.synchronize()
    assert [f.launches for f in (codebook.codebook_fwd_cuda, codebook.codebook_bwd_cuda,
                                 codebook.codebook_bwd_train_cuda)] == [c + 1 for c in counts]
    codebook.check_forward(soft, hard, *codebook.codebook_fwd_plain(z, cb, v, gamma), cb)
    dz_scale, dcb_scale = codebook.backward_error_scale(z, g, cb, pc, v, gamma)
    codebook.check_backward(dz3, codebook.codebook_bwd_plain(z, g, cb, pc, v, gamma), dz_scale)
    dz_ref, dcb_ref = codebook.codebook_bwd_train_plain(z, g, cb, pc, v, gamma)
    codebook.check_backward(dz4, dz_ref, dz_scale)
    codebook.check_backward(dcb, dcb_ref, dcb_scale, 'dcb')
    # K4's reduction has a fixed order: the same inputs give the same bits
    assert torch.equal(codebook.codebook_bwd_train_cuda(z, g, cb, pc, v, gamma)[1], dcb)
    # K3's own case, a fixed codebook on the integers
    z, g, cb, pc = codebook_inputs(n + bpf, n, bpf, cuda)
    codebook.check_backward(codebook.codebook_bwd_cuda(z, g, cb, pc, v, gamma),
                            codebook.codebook_bwd_plain(z, g, cb, pc, v, gamma),
                            codebook.backward_error_scale(z, g, cb, pc, v, gamma)[0])


def near_tie_inputs(seed, n, bpf, kind, device):
    """z at and around the ties of a codebook (every codeword, every midpoint
    of neighbours and 1 and 2 ulps on either side, far values, random ones),
    repeated or cut to N values, with g, the codebook and pc. ``kind``: the
    codebook in order, shuffled and moved off the integers, or with repeated
    codewords, as a trainable codebook may leave it."""
    rng = np.random.default_rng(seed)
    cb = quant.default_codebook(bpf)
    if kind == 'unsorted':
        cb = rng.permutation(cb) + rng.uniform(-0.3, 0.3, cb.size)
    elif kind == 'repeated':
        cb = rng.permutation(np.concatenate([cb[:3 * cb.size // 4],
                                             cb[cb.size // 8:3 * cb.size // 8]]))
    cb = cb.astype(np.float32)
    sorted_cb = np.unique(cb)
    mid = ((sorted_cb[:-1].astype(np.float64) + sorted_cb[1:]) / 2).astype(np.float32)
    steps = [mid]
    for _ in range(2):
        steps = [np.nextafter(steps[0], np.float32(-np.inf))] + steps + [
            np.nextafter(steps[-1], np.float32(np.inf))]
    z = np.concatenate([sorted_cb, *steps, np.float32([-1e3, -40.0, 40.0, 1e3]),
                        rng.standard_normal(512) * 2 ** (bpf - 2)])
    z = np.resize(rng.permutation(z), n).astype(np.float32)
    arrays = (z, rng.standard_normal(n), cb, rng.standard_normal(cb.size))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


# K2, K3 and K4 at exact and near ties: the compiled L = 32 and the generic
# path (L = 16, 64, 256), codebooks in order, shuffled or with repeats; N
# from 1 to past the grid caps. Not one hard index may differ from the
# plain version's (K3 and K4 read pc at the hard index, so a flip shows in
# dz), and K4's dcb must repeat bit for bit.
@pytest.mark.parametrize('n,bpf,kind', [
    (1, 5, 'sorted'), (1, 4, 'unsorted'), (1000, 5, 'sorted'), (1000, 5, 'unsorted'),
    (1000, 5, 'repeated'), (1000, 4, 'unsorted'), (1000, 6, 'repeated'), (1000, 8, 'unsorted'),
    (131072, 5, 'unsorted'), (300001, 5, 'repeated'), (300001, 6, 'unsorted')])
@pytest.mark.parametrize('v,gamma', [(50.0, 25.0), (7.5, 25.0), (0.0, 5.0)])
def test_k2_and_k4_break_ties_as_the_plain_versions(cuda, n, bpf, kind, v, gamma):
    z, g, cb, pc = near_tie_inputs(n + bpf, n, bpf, kind, cuda)
    wrappers = (codebook.codebook_fwd_cuda, codebook.codebook_bwd_cuda,
                codebook.codebook_bwd_train_cuda)
    before = [f.launches for f in wrappers]
    soft, hard = codebook.codebook_fwd_cuda(z, cb, v, gamma)
    dz3 = codebook.codebook_bwd_cuda(z, g, cb, pc, v, gamma)
    dz, dcb = codebook.codebook_bwd_train_cuda(z, g, cb, pc, v, gamma)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [c + 1 for c in before]
    soft_ref, hard_ref = codebook.codebook_fwd_plain(z, cb, v, gamma)
    assert codebook.check_forward(soft, hard, soft_ref, hard_ref, cb)['index_flips'] == 0
    dz_ref, dcb_ref = codebook.codebook_bwd_train_plain(z, g, cb, pc, v, gamma)
    dz_scale, dcb_scale = codebook.backward_error_scale(z, g, cb, pc, v, gamma)
    codebook.check_backward(dz3, dz_ref, dz_scale)
    codebook.check_backward(dz, dz_ref, dz_scale)
    codebook.check_backward(dcb, dcb_ref, dcb_scale, 'dcb')
    assert torch.equal(codebook.codebook_bwd_train_cuda(z, g, cb, pc, v, gamma)[1], dcb)


@pytest.mark.parametrize('trainable', [False, True])
def test_fused_quantizer_launches_its_kernels_on_the_card(cuda, trainable):
    z, _, cb, _ = codebook_inputs(3, 4096, 5, cuda, offset=0.05 if trainable else 0.0)
    z = z.reshape(4, 8, 8, 16).requires_grad_()
    cb.requires_grad_(trainable)
    backward = codebook.codebook_bwd_train_cuda if trainable else codebook.codebook_bwd_cuda
    before = codebook.codebook_fwd_cuda.launches, backward.launches
    q, h, _ = codebook.quantize_with_entropy_fused(z, cb, trainable=trainable)
    (0.001 * (q ** 2).sum() + 10.0 * h).backward()
    assert (codebook.codebook_fwd_cuda.launches, backward.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    q_ref, h_ref, _ = quant.quantize_with_entropy(z.detach(), cb.detach())
    # (hard − soft) + soft: within a float32 ulp of a codeword of magnitude <= 16
    torch.testing.assert_close(q, q_ref, rtol=0, atol=4e-6)
    assert bool(torch.isfinite(z.grad).all()) and (cb.grad is not None) == trainable


def test_dcn_flow_step_launches_k1_k2_k3_on_the_card(cuda):
    """The joint step of the m_quality_dcn lc-0.1000 flow (ONet → jpeg:80 →
    the 32c codec, trainable → FAN) at batch 2: K1 once (the jpeg
    manipulation), K2 once and K3 once a step; K2 alone and K1 once a
    request; the first step within ``compare_flow_steps`` of the CPU's."""
    import chip_smoke
    flow, cpu = chip_smoke.dcn_flow(cuda), chip_smoke.dcn_flow('cpu')
    x = torch.from_numpy(chip_smoke.synthetic_rgb(3, 2, 128, 128))
    chip_smoke.compare_flow_steps(
        flow.loss_and_gradients(x.to(cuda), None, 0.0, chip_smoke.DCN_FLOW_LAMBDA),
        cpu.loss_and_gradients(x, None, 0.0, chip_smoke.DCN_FLOW_LAMBDA),
        chip_smoke.fan_input_flips(flow, cpu, x), part='dcn')
    counters = (jpeg8x8.jpeg_core_cuda, codebook.codebook_fwd_cuda, codebook.codebook_bwd_cuda,
                codebook.codebook_bwd_train_cuda)
    before = [f.launches for f in counters]
    flow.training_step(x.to(cuda), None, 0.0, chip_smoke.DCN_FLOW_LAMBDA)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 0]
    before = [f.launches for f in counters]
    flow.run_workflow_to_decisions(x.to(cuda))
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0]


def test_codebook_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    z, g, cb, pc = codebook_inputs(4, 1024, 5, cuda)
    with pytest.raises(ValueError, match='contiguous'):
        codebook.codebook_fwd_cuda(z[::2], cb)
    with pytest.raises(ValueError, match='one CUDA device'):
        codebook.codebook_bwd_cuda(z, g, cb.cpu(), pc)
    with pytest.raises(ValueError, match='CUDA'):
        codebook.codebook_bwd_train_cuda(z.cpu(), g.cpu(), cb.cpu(), pc.cpu())
    with pytest.raises(ValueError, match='must match'):
        codebook.codebook_bwd_cuda(z, g[:-1], cb, pc)


def test_full_width_training_step_on_the_card(cuda):
    """The joint step of the shipped m_quality run at full width (batch 20,
    raw 128 px, NIP trainable): K1 twice, finite losses, and the loss parts
    and gradient norms within ``compare_steps`` of the port's CPU step on the
    same batch and weights."""
    import chip_smoke
    from neural_imaging_tpu_torch.workflows.manipulation_classification import (
        ManipulationClassification, compare_steps)
    run = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       chip_smoke.RUN_DIR)
    flow = ManipulationClassification.restore(run, 128, trainable={'nip'}, device=cuda)
    cpu = ManipulationClassification.restore(run, 128, trainable={'nip'}, device='cpu')
    (bx, by), = chip_smoke.training_batches(5, 1, 20)
    compare_steps(flow.loss_and_gradients(bx, by, 0.1),
                  cpu.loss_and_gradients(bx.cpu(), by.cpu(), 0.1))
    before = jpeg8x8.jpeg_core_cuda.launches
    loss, parts = flow.training_step(bx, by, 0.1)
    torch.cuda.synchronize()
    assert jpeg8x8.jpeg_core_cuda.launches == before + 2
    assert all(np.isfinite(float(v)) for v in (loss, *parts.values()))
    # quantized batches are normalized on the card as on the CPU
    from neural_imaging_tpu_torch.ops import ops
    for dtype, top in ((np.uint16, 65535), (np.uint8, 255)):
        q = torch.from_numpy(np.random.default_rng(6).integers(0, top + 1, (2, 8, 8, 3))
                             .astype(dtype))
        assert torch.equal(ops.normalize_batch(q.to(cuda)).cpu(), ops.normalize_batch(q))


def test_bf16_fan_conv_on_the_card_sums_in_float32(cuda):
    """One bfloat16 conv of the FAN's widths (conv1: 32 → 64 channels, 5x5,
    at 64 px) on the card against the CPU's, which is the reference's bit for
    bit: at least 99% of the values equal; and the conv before its bias
    within one bfloat16 ulp of the exact conv of the same operands rounded
    once, plus the float32 sums' own error (800 terms: 2^-14 of the sum of
    their magnitudes), which a bfloat16 accumulation would miss by many ulps."""
    import torch.nn.functional as F
    from neural_imaging_tpu_torch.models import forensics
    from neural_imaging_tpu_torch.utils.device import resolve_device
    resolve_device('cuda')
    fan = forensics.FAN(n_classes=5, dtype='bfloat16', device='cpu')
    layer = fan.module.conv1
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 32, 64, 64))
                         .astype(np.float32)).to(torch.bfloat16)
    w = layer.weight.detach().to(torch.bfloat16)
    cpu = fan.module._conv(layer, x)
    card = fan.module.to(cuda)._conv(layer, x.to(cuda)).cpu()
    assert card.dtype == torch.bfloat16
    assert float((card == cpu).float().mean()) >= 0.99
    conv = F.conv2d(x.to(cuda), w.to(cuda), padding='same').float().cpu()
    exact = F.conv2d(x.double(), w.double(), padding='same')
    terms = F.conv2d(x.float().abs(), w.float().abs(), padding='same')
    exact = exact.to(torch.bfloat16).float()
    ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp(min=1e-30))) - 7)
    assert bool(((conv - exact).abs() <= ulp + 2.0 ** -14 * terms).all())


def test_bf16_products_on_the_card_round_once(cuda):
    """With the flags ``resolve_device`` sets (TF32 off, no bfloat16 split
    reductions), the bfloat16 products of the flat pool, the resize and the
    plane-form JPEG on the card: the pool bit-equal to the CPU's (its sums
    are exact), a long product within one bfloat16 ulp of the float32 product
    rounded once, and the JPEG bit-equal in at least 99% of its values."""
    from neural_imaging_tpu_torch.models import jpeg as jpeg_models
    from neural_imaging_tpu_torch.ops import ops
    from neural_imaging_tpu_torch.utils.device import resolve_device
    resolve_device('cuda')
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.random((20, 3, 256, 256)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(ops.avg_pool_flat(x.to(cuda), 2).cpu(), ops.avg_pool_flat(x, 2))
    # positive terms: no cancellation, so a float32 sum of 8192 terms lies
    # within 2^-11 of the exact one, less than half a bfloat16 ulp
    a = torch.from_numpy(rng.random((256, 8192)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.random((8192, 256)).astype(np.float32)).to(torch.bfloat16)
    card = ops.matmul(a.to(cuda), b.to(cuda)).float().cpu()
    exact = (a.double() @ b.double()).to(torch.bfloat16).float()
    ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp(min=1e-30))) - 7)
    assert bool(((card - exact).abs() <= ulp).all())
    ql, qc = jpeg_qtable(50, 0), jpeg_qtable(50, 1)
    y_card = jpeg_models.jpeg_forward_nchw(x[:4].to(cuda), ql, qc, precision='default')[0]
    y_cpu = jpeg_models.jpeg_forward_nchw(x[:4], ql, qc, precision='default')[0]
    assert y_card.dtype == torch.bfloat16
    assert float((y_card.cpu() == y_cpu).float().mean()) >= 0.99


@pytest.fixture(scope='module')
def fixture_data(tmp_path_factory):
    from neural_imaging_tpu_torch.data import fixtures
    from neural_imaging_tpu_torch.data.dataset import Dataset
    directory = fixtures.make_dataset(str(tmp_path_factory.mktemp('data')), n_images=6,
                                      height=64, width=96)
    return Dataset(directory, n_images=4, v_images=2, val_rgb_patch_size=32, val_n_patches=2)


def test_device_sampler_on_the_card_keeps_the_cpu_patches(cuda, fixture_data):
    """The card's gather and ranking (int16 bit patterns, a CUDA generator)
    against the CPU sampler's on the same candidate draws."""
    from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
    card = DeviceSampler(fixture_data, 3, 32, device=cuda)
    cpu = DeviceSampler(fixture_data, 3, 32, device='cpu')
    for step in range(5):
        draws = card.draw(step)
        assert all(t.device.type == 'cuda' for t in draws)
        raw, rgb = card.sample(*draws)
        ref_raw, ref_rgb = cpu.sample(*(t.cpu() for t in draws))
        assert raw.dtype == torch.uint16 and rgb.dtype == torch.uint8
        assert torch.equal(raw.cpu().view(torch.int16), ref_raw.view(torch.int16))
        assert torch.equal(rgb.cpu(), ref_rgb)
    first = card(7)
    assert all(torch.equal(a, b) for a, b in zip(first, card(7)))


def test_prefetcher_copies_pinned_batches_intact(cuda, fixture_data):
    """Batches copied through pinned memory without waiting equal the
    host's, while the card is kept busy between them."""
    from neural_imaging_tpu_torch.data.dataset import Dataset
    from neural_imaging_tpu_torch.data.prefetch import EpochPrefetcher
    ref = Dataset(fixture_data._data_directory, n_images=4, v_images=2,
                  val_rgb_patch_size=32, val_n_patches=2)
    data = Dataset(fixture_data._data_directory, n_images=4, v_images=2,
                   val_rgb_patch_size=32, val_n_patches=2)
    prefetcher = EpochPrefetcher(data, 2, 32, cuda)
    for _ in range(3):
        expected = list(ref.get_training_generator(2, 32, 'flat', quantized=True))
        got = []
        for x, y in prefetcher:
            torch.cuda._sleep(1_000_000)         # the next copies queue behind device work
            got.append((x.cpu(), y.cpu()))
        assert len(got) == len(expected)
        for (x, y), (ref_x, ref_y) in zip(got, expected):
            assert x.device.type == 'cpu' and torch.equal(x.view(torch.int16),
                                                           torch.from_numpy(ref_x.view('int16')))
            assert torch.equal(y, torch.from_numpy(ref_y))


# -- the other camera ISPs --------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOTS = {'UNet': 'data/models/nip/QualityRef/UNet_5',
             'DNet': 'data/models/nip/QualityRef/DNet_3x3_15x64f',
             'ClassicISP': 'data/models/nip/QualityRef/ClassicISP_gbrg_5x5_-3R'}


@pytest.mark.parametrize('name', sorted(SNAPSHOTS))
def test_shipped_nip_on_the_card_matches_the_cpu(cuda, name):
    """Each shipped NIP develops the same RGB on the card as on the CPU,
    within chip_smoke.MAX_NIP_DIFF (float32 in another summation order)."""
    from chip_smoke import MAX_NIP_DIFF
    from neural_imaging_tpu_torch.models import base, pipelines
    path = os.path.join(ROOT, SNAPSHOTS[name])
    x = np.random.default_rng(3).random((4, 32, 32, 4)).astype(np.float32)
    card = base.restore(path, pipelines, patch_size=32, device=cuda).process(x)
    cpu = base.restore(path, pipelines, patch_size=32, device='cpu').process(x)
    assert card.device.type == 'cuda'
    assert float((card.cpu() - cpu).abs().max()) <= MAX_NIP_DIFF


def test_nip_training_step_and_scan_on_the_card(cuda, fixture_data):
    """NIPModel.training_step returns a loss on the card without a host
    sync, moves the weights, and training_scan steps on device draws."""
    from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
    from neural_imaging_tpu_torch.models import pipelines
    model = pipelines.UNet(patch_size=16, n_steps=3, device=cuda)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    bx, by = fixture_data.next_training_batch(0, 2, 32, quantized=True)
    loss = model.training_step(bx, by, 1e-4)
    assert loss.device.type == 'cuda' and loss.shape == ()
    losses = model.training_scan(DeviceSampler(fixture_data, 2, 32, device=cuda), 3, 1e-4)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert all(not torch.equal(v, before[k]) for k, v in model.module.state_dict().items())


def test_remat_on_the_card_keeps_the_step(cuda):
    """remat recomputes the NIP and the manipulations in the backward pass:
    the same loss and gradients (compare_steps), K1 once more."""
    from neural_imaging_tpu_torch.workflows.manipulation_classification import (
        ManipulationClassification, compare_steps)
    flows = [ManipulationClassification('UNet', fan_args={'n_filters': 8, 'n_convolutions': 2},
                                        nip_args={'n_steps': 3}, trainable={'nip'},
                                        raw_patch_size=16, remat=remat, device=cuda)
             for remat in (False, True)]
    x = torch.rand(2, 16, 16, 4, device=cuda)
    y = torch.rand(2, 32, 32, 3, device=cuda)
    steps, launches = [], []
    for flow in flows:
        before = jpeg8x8.jpeg_core_cuda.launches
        steps.append(flow.loss_and_gradients(x, y, 0.1))
        launches.append(jpeg8x8.jpeg_core_cuda.launches - before)
    compare_steps(steps[1], steps[0])
    assert launches == [2, 3]


def test_percentile_normalize_beyond_the_quantile_limit(cuda):
    """More than 2^24 values, which torch.quantile refuses: the card's
    result equals the CPU's."""
    from neural_imaging_tpu_torch.ops import ops
    x = torch.rand(2 ** 24 + 7, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(ops.percentile_normalize(x.to(cuda)).cpu(),
                               ops.percentile_normalize(x), rtol=0, atol=0)


def test_eight_class_step_on_the_card(cuda):
    """The joint step with all seven manipulations (chip_smoke's manip7 flow:
    the m_quality INet, an 8-class FAN from its seed) at batch 4, raw 128:
    K1 twice, and the loss parts and gradient norms within
    ``compare_flow_steps`` of the CPU step with the same awgn noise."""
    import chip_smoke
    flow, cpu = chip_smoke.manip7_flow(cuda), chip_smoke.manip7_flow('cpu')
    (bx, by), = chip_smoke.training_batches(7, 1, 4)
    noise = chip_smoke.awgn_noise(8, 4, 256)
    before = jpeg8x8.jpeg_core_cuda.launches
    step = flow.loss_and_gradients(bx, by, 0.1, noise=noise.to(cuda))
    assert jpeg8x8.jpeg_core_cuda.launches == before + 2
    chip_smoke.compare_flow_steps(step, cpu.loss_and_gradients(bx.cpu(), by.cpu(), 0.1,
                                                               noise=noise),
                                  chip_smoke.fan_input_flips(flow, cpu, bx, noise))
    loss, _ = flow.training_step(bx, by, 0.1, augment=True)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize('index', range(8))
def test_median_switch_equals_median_on_the_card(cuda, index):
    """median_switch's one sort of the 9x9 window's views, the views outside
    the k x k block set to ±inf, against median(x, k): value and gradient
    bit for bit on the card, saturated (tied) blocks included."""
    from neural_imaging_tpu_torch.ops import manipulations as manips
    candidates = [3, 5, 7, 9]
    rng = np.random.default_rng(index)
    x = rng.random((2, 3, 64, 64)).astype(np.float32)
    x[0, :, 8:24, 8:24] = 1.0
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(cuda)
    outs = []
    for fn in (lambda v: manips.median_switch(v, torch.tensor(index, device=cuda), candidates),
               lambda v: manips.median(v, candidates[min(index, 3)])):
        v = torch.from_numpy(x).to(cuda).requires_grad_(True)
        y = fn(v)
        y.backward(g)
        outs.append((y.detach(), v.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# -- RAW ingestion and development ------------------------------------------------------

@pytest.mark.parametrize('demosaicing', ['bilinear', 'malvar', 'menon'])
@pytest.mark.parametrize('cfa', ['GBRG', 'RGGB'])
def test_development_on_the_card_matches_the_cpu(cuda, demosaicing, cfa):
    """raw.develop in float64 on the card against the CPU: the same
    operations in the same order, so Menon decides every direction alike
    and the values agree within chip_smoke.MAX_DEVELOP_DIFF (the last bit
    of pow may differ)."""
    from chip_smoke import MAX_DEVELOP_DIFF
    from neural_imaging_tpu_torch.data import menon, raw
    m = np.random.default_rng(7).random((256, 384)) ** 2
    m[:64, :96] = 0.25                                  # a flat region: tied directions
    srgb = np.array([[1.8, -0.6, -0.2], [0.0, 1.3, -0.3], [0.1, -0.4, 1.3]])
    card = raw.develop(m, cfa, srgb, brightness='percentile', demosaicing=demosaicing,
                       device=cuda)
    cpu = raw.develop(m, cfa, srgb, brightness='percentile', demosaicing=demosaicing,
                      device='cpu')
    assert card.device.type == 'cuda' and card.dtype == torch.float64
    if demosaicing == 'menon':
        t = torch.from_numpy(m)
        assert torch.equal(menon.directions(t.to(cuda), cfa)[0].cpu(), menon.directions(t, cfa)[0])
    assert float((card.cpu() - cpu).abs().max()) <= MAX_DEVELOP_DIFF


def test_ljpeg_library_builds_and_codes_as_the_plain_loops():
    """The scan codec built from native/ljpeg/ljpeg.cpp with g++ (no card
    needed, but this is the GPU machine's toolchain) codes and decodes as the
    Python loops, bit for bit."""
    from neural_imaging_tpu_torch.data import ljpeg
    path = ljpeg.build()
    assert path == ljpeg.library_path() and path.exists()
    s = np.random.default_rng(2).integers(0, 1 << 14, (24, 40, 2)).astype(np.uint16)
    stream = ljpeg.encode(s, precision=14)
    assert stream == ljpeg.encode_plain(s, precision=14)
    assert np.array_equal(ljpeg.decode(stream)[0], s)


def test_nip_full_stack_on_the_card_matches_a_cpu_crop(cuda):
    """INet develops a 512x768 RGGB stack in one forward on the card; a crop
    of the stack developed on the CPU gives the same RGB away from the
    crop's border, within MAX_NIP_DIFF."""
    from chip_smoke import MAX_NIP_DIFF
    from neural_imaging_tpu_torch.cli import develop_images
    from neural_imaging_tpu_torch.models import base, pipelines
    path = os.path.join(ROOT, 'data/models/nip/QualityRef/INet_gbrg_5x5')
    # away from black, where gamma's slope turns float32 noise into 1e-4
    stack = (0.05 + 0.9 * np.random.default_rng(4).random((512, 768, 4))).astype(np.float32)
    card = base.restore(path, pipelines, device=cuda)
    with torch.inference_mode():
        full = card.process(stack[None])[0].cpu()
    assert tuple(full.shape) == (1024, 1536, 3)
    cpu = base.restore(path, pipelines, device='cpu').process(stack[None, 100:164, 200:264])[0]
    m = 16
    d = (full[200 + m:328 - m, 400 + m:528 - m] - cpu[m:-m, m:-m]).abs().max()
    assert float(d) <= MAX_NIP_DIFF
    rgb = develop_images.develop_stack(card, stack)
    assert rgb.shape == (1024, 1536, 3) and rgb.dtype == np.uint8


def test_baseline_jpeg_library_builds_and_codes_as_the_plain_version():
    """The host JPEG codec built from csrc/baseline_jpeg.cpp with g++ (no
    card needed, but this is the GPU machine's toolchain): the files and
    decodes of its plain version, and the committed digests of PIL's."""
    from neural_imaging_tpu_torch.compression import baseline_jpeg
    from neural_imaging_tpu_torch.data import fixtures
    path = baseline_jpeg.build()
    assert path == baseline_jpeg.library_path() and path.exists()
    image = (fixtures.procedural_image(40, 56, 3) * 255).astype(np.uint8)
    for subsampling in baseline_jpeg.SUBSAMPLING:
        data = baseline_jpeg.encode(image, 70, subsampling)
        assert data == baseline_jpeg.encode_plain(image, 70, subsampling)
        assert np.array_equal(baseline_jpeg.decode(data), baseline_jpeg.decode_plain(data))
    assert baseline_jpeg.digest_mismatches() == []


def test_djpeg_sweep_launches_k1_once_a_quality_on_the_card(cuda):
    """test_jpeg's dJPEG: one K1 launch a quality, its PSNR within 1e-3 dB of
    the CPU's (K1 against its plain version: rounding ties only)."""
    from neural_imaging_tpu_torch.models.jpeg import JPEG
    from neural_imaging_tpu_torch.utils import metrics
    batch = np.random.default_rng(8).random((2, 64, 96, 3)).astype(np.float32)
    card, cpu = JPEG(50, 'soft', device=cuda), JPEG(50, 'soft', device='cpu')
    before = jpeg8x8.jpeg_core_cuda.launches
    for quality in (20, 50, 90):
        y = card.process(torch.from_numpy(batch), quality).cpu().numpy()
        y_cpu = cpu.process(torch.from_numpy(batch), quality).numpy()
        assert abs(np.mean(metrics.psnr(batch, y)) - np.mean(metrics.psnr(batch, y_cpu))) <= 1e-3
    assert jpeg8x8.jpeg_core_cuda.launches == before + 3


def test_dcn_leg_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The R/D sweep's DCN leg (8c) on the card: one K2 launch a row; the
    CPU's bytes within 1% (equal unless a latent index flipped on a rounding
    tie), SSIM within 1e-5."""
    from neural_imaging_tpu_torch.compression import ratedistortion as rd
    from neural_imaging_tpu_torch.data import fixtures, png
    for i in range(2):
        image = (fixtures.procedural_image(64, 96, 30 + i) * 255).astype(np.uint8)
        png.write_png(str(tmp_path / f'{i}.png'), image)
    model_dir = os.path.join(ROOT, 'data/models/dcn/baselines/8c')
    before = codebook.codebook_fwd_cuda.launches
    card = rd.get_dcn_df(str(tmp_path), model_dir, device=cuda)
    assert codebook.codebook_fwd_cuda.launches == before + 2
    cpu = rd.get_dcn_df(str(tmp_path), model_dir, force_calc=True, device='cpu')
    np.testing.assert_allclose(card['ssim'].astype(float), cpu['ssim'].astype(float),
                               rtol=0, atol=1e-5)
    assert np.abs(card['bytes'] - cpu['bytes']).max() <= 0.01 * cpu['bytes'].max()


@pytest.mark.parametrize('kernel', ['jpeg8x8', 'codebook_fwd', 'codebook_bwd',
                                    'codebook_bwd_train'])
def test_registered_operators_launch_the_kernels(cuda, kernel):
    """Each kernel's operator launches it once (its counter) and gives the
    launcher's results; FlopCounterMode and the byte counter see it with
    its work."""
    from neural_imaging_tpu_torch.ops.hopper import registry
    from neural_imaging_tpu_torch.utils import profiling
    if kernel == 'jpeg8x8':
        args, launcher = inputs(3, 3, 16, 24, 50, cuda), jpeg8x8.jpeg_core_cuda
    else:
        z, g, cb, pc = codebook_inputs(4, 777, 5, cuda)
        launcher = getattr(codebook, f'{kernel}_cuda')
        args = (z, cb) if kernel == 'codebook_fwd' else (z, g, cb, pc)
    op, work = registry.OPS[kernel]
    full = (*args, 50.0, 25.0) if kernel != 'jpeg8x8' else args
    before = launcher.launches
    got = op(*full)
    want = launcher(*full)
    torch.cuda.synchronize()
    assert launcher.launches == before + 2
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    cost = profiling.step_cost(lambda: op(*full))
    shapes = [a.shape for a in args]
    assert cost['flops_by_kernel'] == {kernel: work(*shapes)[0]}
    assert cost['bytes_accessed'] == work(*shapes)[1]


def test_exported_dcn_launches_k2_on_the_card(cuda, tmp_path):
    """deploy_model of the 32c codec on the card: the program holds K2's
    operator, reloads, launches K2 once a call and gives the model's output."""
    from neural_imaging_tpu_torch.compression import codec
    dcn = codec.restore('32c', device=cuda)
    dcn.deploy_model(str(tmp_path / 'dcn'), batch_size=1, patch_size=128)
    program = torch.export.load(str(tmp_path / 'dcn' / 'model.pt2'))
    assert any('codebook_fwd' in str(n.target) for n in program.graph.nodes)
    x = torch.rand((1, 128, 128, 3), generator=torch.Generator().manual_seed(5)).to(cuda)
    before = codebook.codebook_fwd_cuda.launches
    with torch.no_grad():
        y, entropy = program.module()(x)
    torch.cuda.synchronize()
    assert codebook.codebook_fwd_cuda.launches == before + 1
    with torch.no_grad():
        y_ref, entropy_ref = dcn.serve(x)
    assert float((y - y_ref).abs().max()) <= 1e-5 and float(abs(entropy - entropy_ref)) <= 1e-5
