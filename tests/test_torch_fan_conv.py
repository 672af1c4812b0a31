"""K5, the FAN's fused conv stage (``ops/hopper/fan_conv.py``), on the CPU: its
work functions, its operators' fake outputs, the FAN's choice of path, the
plain versions against PyTorch's composition and its autograd, and the CUDA
source built for the host (``tests/support/fan_conv_host.py``) through the
launchers against the plain versions. The kernels on the card:
``tests/test_torch_gpu.py``."""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_imaging_tpu_torch.models import forensics
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.ops.hopper import _build, fan_conv

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'support'))
import fan_conv_host  # noqa: E402

# the stages of the repository's FANs: (Cin, Cout, side) at 128-px patches
STAGES = [(3, 32, 128), (32, 64, 64), (64, 128, 32), (128, 256, 16)]
COUNTERS = (fan_conv.fan_conv_fwd_cuda, fan_conv.fan_conv_dgrad_cuda,
            fan_conv.fan_conv_wgrad_cuda)


def stage_inputs(seed, n, c_in, c_out, side, width=None):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, c_in, side, width or side), generator=g)
    w = torch.randn((c_out, c_in, 5, 5), generator=g) / (5 * c_in ** 0.5)
    b = torch.randn((c_out,), generator=g) * 0.1
    return x, w, b


def composition(x, w, b):
    """The FAN's stage as FANCore composes it off the kernel path."""
    return ops.max_pool(ops.leaky_relu(F.conv2d(x, w, b, padding=2)), 2)


@pytest.mark.parametrize('n', [100, 50])
@pytest.mark.parametrize('c_in,c_out,side', STAGES)
def test_work_counts_dense_forward_and_quarter_backward(n, c_in, c_out, side):
    x, wt, pooled = (n, c_in, side, side), (c_out, c_in, 5, 5), (n, c_out, side // 2, side // 2)
    dense = 2 * n * side * side * c_in * c_out * 25
    fwd = fan_conv.fan_conv_fwd_work(x, wt, (c_out,))
    dgrad = fan_conv.fan_conv_dgrad_work(pooled, pooled, wt)
    wgrad = fan_conv.fan_conv_wgrad_work(pooled, pooled, x)
    assert fwd[0] == dense and dgrad[0] == wgrad[0] == dense // 4
    pooled_n, x_n, w_n = n * c_out * side * side // 4, n * c_in * side * side, c_out * c_in * 25
    assert fwd[1] == 4 * (x_n + w_n + c_out) + 5 * pooled_n
    assert dgrad[1] == 5 * pooled_n + 4 * w_n + 4 * x_n
    assert wgrad[1] == 5 * pooled_n + 4 * x_n + 4 * (w_n + c_out)
    if (n, side) == (100, 64):      # the issue's count: conv1 of 100 images, 4.19e10 forward
        assert round(fwd[0] / 1e10, 2) == 4.19


@pytest.mark.parametrize('c_in,c_out,side', STAGES)
def test_operators_fake_uint8_codes_one_a_pooled_output(c_in, c_out, side):
    x = torch.empty(7, c_in, side, side, device='meta')
    w = torch.empty(c_out, c_in, 5, 5, device='meta')
    y, code = fan_conv.fan_conv_fwd_op(x, w, torch.empty(c_out, device='meta'))
    assert (tuple(y.shape), y.dtype) == ((7, c_out, side // 2, side // 2), torch.float32)
    assert (tuple(code.shape), code.dtype) == ((7, c_out, side // 2, side // 2), torch.uint8)
    dx = fan_conv.fan_conv_dgrad_op(y, code, w)
    assert (tuple(dx.shape), dx.dtype) == ((7, c_in, side, side), torch.float32)
    dw, db = fan_conv.fan_conv_wgrad_op(y, code, x)
    assert [(tuple(t.shape), t.dtype) for t in (dw, db)] == [((c_out, c_in, 5, 5), torch.float32),
                                                            ((c_out,), torch.float32)]


def fan_core(**kw):
    args = dict(n_classes=5, use_gap=True, n_dense=0, seed=3)
    args.update(kw)
    return forensics.FANCore(**args)


@pytest.mark.parametrize('kw,device,dtype,side,path', [
    ({}, 'cuda', torch.float32, 128, 'kernel'),
    ({}, 'cuda', torch.float32, 64, 'kernel'),
    ({}, 'cpu', torch.float32, 128, 'plain'),
    ({}, 'cuda', torch.bfloat16, 128, 'plain'),
    ({'dtype': torch.bfloat16}, 'cuda', torch.float32, 128, 'plain'),
    ({'kernel': 3}, 'cuda', torch.float32, 128, 'plain'),
    ({'activation': 'relu'}, 'cuda', torch.float32, 128, 'plain'),
    ({'n_filters': 8, 'n_convolutions': 2}, 'cuda', torch.float32, 128, 'plain'),
    ({'n_fscale': 1.5}, 'cuda', torch.float32, 128, 'plain'),
    ({}, 'cuda', torch.float32, 100, 'plain'),       # 100 → 50 → 25: an odd side
    ({'stem': 'fused'}, 'cuda', torch.float32, 128, 'kernel'),
    ({'stem': 'fused', 'n_convolutions': 1}, 'cuda', torch.float32, 128, 'plain'),
])
def test_fan_chooses_k5_from_what_it_can_observe(kw, device, dtype, side, path):
    assert fan_core(**kw).conv_path(device, dtype, side, side) == path


def test_k5_takes_the_widths_of_the_repository_fans():
    assert all(fan_conv.supports(c_in, c_out) for c_in, c_out, _ in STAGES)
    assert not any(fan_conv.supports(c_in, c_out, k) for c_in, c_out, k in
                   [(3, 8, 5), (8, 16, 5), (32, 64, 3), (16, 32, 5), (32, 48, 5), (32, 32, 5)])


def test_cpu_fan_takes_the_composition_bit_for_bit():
    core = fan_core()
    x = torch.rand((3, 3, 64, 64), generator=torch.Generator().manual_seed(4))
    before = [f.launches for f in COUNTERS]
    with torch.no_grad():
        got = core(x)
        h = core.constrained(x)
        for i in range(4):
            layer = getattr(core, f'conv{i}')
            h = ops.max_pool(core.act(layer(h)), 2)
        h = ops.global_average_pool(core.act(core.proj(h)))
        want = torch.softmax(core.head(h), dim=-1)
    assert torch.equal(got, want)
    assert [f.launches for f in COUNTERS] == before


def test_fan_builds_nothing_at_construction(monkeypatch):
    """K5's library is built on its first launch, as K1-K4's are: a FAN that
    takes K5 starts no compiler when it is made."""
    monkeypatch.setattr(_build, 'build', lambda *a, **k: pytest.fail('built at construction'))
    monkeypatch.setattr(forensics.FANCore, 'conv_path', lambda self, *a: 'kernel')
    forensics.FAN(n_classes=5, device='cpu')


@pytest.mark.parametrize('c_in,c_out,side', [(3, 32, 16), (32, 64, 8), (64, 128, 6)])
def test_plain_forward_is_the_composition_and_its_code(c_in, c_out, side):
    x, w, b = stage_inputs(c_in + side, 2, c_in, c_out, side)
    y, code = fan_conv.fan_conv_fwd_plain(x, w, b)
    assert torch.equal(y, composition(x, w, b)) and code.dtype == torch.uint8
    v = F.conv2d(x, w, b, padding=2)
    windows = v.unfold(2, 2, 2).unfold(3, 2, 2).reshape(*y.shape, 4)
    at = (code & 3).long()
    winner = windows.gather(-1, at[..., None])[..., 0]
    assert torch.equal(F.leaky_relu(winner, 0.2), y)
    assert torch.equal((code & 4) != 0, winner >= 0) and int(code.max()) < 8


@pytest.mark.parametrize('c_in,c_out,side', [(3, 32, 16), (32, 64, 8)])
def test_stage_gradients_are_the_compositions(c_in, c_out, side):
    """The stage's autograd (its plain dgrad and wgrad on the CPU) against
    autograd through the composition, with jax's derivative 1 of the
    activation at 0 (a zero input and bias: pre-activations of exactly 0)."""
    x, w, b = stage_inputs(side, 2, c_in, c_out, side)
    x[0, :, :6, :6] = 0.0
    b[::3] = 0.0
    g = torch.randn((2, c_out, side // 2, side // 2), generator=torch.Generator().manual_seed(1))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    fan_conv.fan_conv_stage(*leaves).backward(g)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    composition(*ref).backward(g)
    torch.testing.assert_close(leaves[0].grad, ref[0].grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(leaves[1].grad, ref[1].grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(leaves[2].grad, ref[2].grad, rtol=1e-5, atol=1e-6)


def test_expanded_gradient_puts_each_window_at_its_winner():
    """The code's position (bits 0-1, row-major) takes the pooled gradient,
    times the slope where bit 2 (pre-activation >= 0) is clear; the window's
    3 other positions take exact zeros, even beside a NaN gradient."""
    dy = torch.tensor([[[[1.0, 2.0], [float('nan'), -4.0]]]])
    code = torch.tensor([[[[0 | 4, 1], [2 | 4, 3]]]], dtype=torch.uint8)
    full = fan_conv.expand_gradient(dy, code)[0, 0]
    want = torch.tensor([[1.0, 0.0, 0.0, 2.0 * 0.2],
                         [0.0, 0.0, 0.0, 0.0],
                         [0.0, 0.0, 0.0, 0.0],
                         [float('nan'), 0.0, 0.0, -4.0 * np.float32(0.2)]])
    torch.testing.assert_close(full, want, equal_nan=True, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w, b = stage_inputs(0, 1, 32, 64, 8)
    with pytest.raises(TypeError, match='float32'):
        fan_conv.fan_conv_fwd_cuda(x.to(torch.bfloat16), w, b)
    with pytest.raises(ValueError, match='5x5'):
        fan_conv.fan_conv_fwd_cuda(x, w[:, :, :3, :3].contiguous(), b)
    with pytest.raises(ValueError, match='even sides'):
        fan_conv.fan_conv_fwd_cuda(x[:, :, :7, :], w, b)
    with pytest.raises(ValueError, match='CUDA'):
        fan_conv.fan_conv_fwd_cuda(x, w, b)
    y, code = fan_conv.fan_conv_fwd_plain(x, w, b)
    with pytest.raises(TypeError, match='uint8'):
        fan_conv.fan_conv_dgrad_cuda(y, code.int(), w)
    with pytest.raises(ValueError, match='CUDA'):
        fan_conv.fan_conv_wgrad_cuda(y, code, x)
    with pytest.raises(ValueError, match='multiple of 32'):
        fan_conv.fan_conv_wgrad_cuda(y[:, :48].contiguous(), code[:, :48].contiguous(), x)
    with pytest.raises(NotImplementedError):     # the operators are for CUDA tensors
        fan_conv.fan_conv_fwd_op(x, w, b)


def test_build_compiles_a_missing_library_once(tmp_path, monkeypatch):
    """``build`` runs nvcc for a library that is missing, keeps its log beside
    it, and runs nothing for one that is built."""
    nvcc = tmp_path / 'nvcc'
    calls = tmp_path / 'calls'
    nvcc.write_text(f'#!/bin/sh\necho x >> {calls}\n'
                    'while [ "$#" -gt 0 ]; do if [ "$1" = -o ]; then touch "$2"; fi; shift; done\n'
                    'echo "ptxas info    : Used 1 registers"\n')
    nvcc.chmod(0o755)
    (tmp_path / 'k.cu').write_text('// k\n')
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, 'nvcc_path', lambda: nvcc)
    path = _build.build(['k'], csrc_dir=tmp_path)['k']
    assert path.exists() and 'registers' in path.with_suffix('.log').read_text()
    assert _build.build(['k'], csrc_dir=tmp_path) == {'k': path}
    assert calls.read_text().count('x') == 1


def test_smoke_holds_k5_counts_exactly_or_as_whole_fan_passes():
    """chip_smoke's launch check: K5's counts exactly where a phase names
    them; elsewhere whole passes of the FAN's 4 stages, no backward without
    its forward."""
    import chip_smoke
    zero = dict.fromkeys(chip_smoke.COUNTERS, 0)
    assert set(chip_smoke.K5_COUNTERS) <= set(chip_smoke.COUNTERS)
    step = {**zero, 'jpeg8x8': 2, **chip_smoke.fan_passes(1, 1)}
    assert step['fan_conv_fwd'] == step['fan_conv_dgrad'] == step['fan_conv_wgrad'] == 4
    chip_smoke.expect_counts('step', step, {'jpeg8x8': 2, **chip_smoke.fan_passes(1, 1)})
    chip_smoke.expect_counts('any FAN', step, {'jpeg8x8': 2})
    chip_smoke.expect_counts('no FAN', zero, chip_smoke.NO_K5)
    for counts, expected in [(step, {'jpeg8x8': 2, **chip_smoke.fan_passes(1)}),
                             (step, {'jpeg8x8': 2, **chip_smoke.NO_K5}),
                             ({**step, 'fan_conv_fwd': 3}, {'jpeg8x8': 2}),
                             ({**step, 'fan_conv_fwd': 0}, {'jpeg8x8': 2}),
                             ({**step, 'fan_conv_wgrad': 8}, {'jpeg8x8': 2}),
                             (step, {'jpeg8x8': 1})]:
        with pytest.raises(AssertionError):
            chip_smoke.expect_counts('path', counts, expected)


# -- the CUDA source, built for the host ------------------------------------------

@pytest.fixture(scope='module')
def host_kernels():
    library = fan_conv_host.load()
    if library is None:
        pytest.skip('needs g++ with C++20 to build the kernels for the host')
    return library


@pytest.fixture
def on_host(host_kernels, monkeypatch):
    """The launchers with the host build in place of the card's library."""
    monkeypatch.setattr(fan_conv, '_library', lambda: host_kernels)
    monkeypatch.setattr(fan_conv, '_check_device', lambda name, tensors: (tensors[0].device, None))
    fan_conv._wgrad_splits.cache_clear()
    yield
    fan_conv._wgrad_splits.cache_clear()


def relative(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# the kernels' tiles: the stem (3 → 32, and its 3-channel dgrad and wgrad), the
# 64-channel forward and dgrad, conv1's 32-channel dgrad, ragged tiles (a side
# not a multiple of the tile's), several ci tiles, a forward reduction long
# enough to sum each stage apart (128 input channels), and enough positions
# for the wgrad's split sums to group
@pytest.mark.parametrize('n,c_in,c_out,h,w', [(2, 3, 32, 16, 16), (1, 3, 32, 10, 34),
                                              (1, 32, 64, 8, 20), (2, 32, 64, 10, 6),
                                              (1, 64, 64, 4, 4), (1, 128, 64, 4, 4),
                                              (8, 3, 32, 64, 64)])
def test_host_build_of_the_kernels_matches_the_plain_versions(on_host, n, c_in, c_out, h, w):
    """Also planted ties: where the input is 0 over a window's reach its 4
    pre-activations are the bias exactly (0 for some channels: the
    activation's derivative at 0), and the first position wins."""
    x, wt, b = stage_inputs(h * w + c_in, n, c_in, c_out, h, w)
    x[0, :, :h // 2, :w // 2] = 0.0
    b[::3] = 0.0
    before = [f.launches for f in COUNTERS]
    y, code = fan_conv.fan_conv_fwd_cuda(x, wt, b)
    y_p, code_p = fan_conv.fan_conv_fwd_plain(x, wt, b)
    assert relative(y, y_p) < 1e-5 and torch.equal(code, code_p)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    assert relative(fan_conv.fan_conv_dgrad_cuda(dy, code, wt),
                    fan_conv.fan_conv_dgrad_plain(dy, code, wt)) < 1e-5
    dw, db = fan_conv.fan_conv_wgrad_cuda(dy, code, x)
    dw_p, db_p = fan_conv.fan_conv_wgrad_plain(dy, code, x)
    assert relative(dw, dw_p) < 1e-5 and relative(db, db_p) < 1e-5
    assert [f.launches - k for f, k in zip(COUNTERS, before)] == [1, 1, 1]
    assert fan_conv.fan_conv_fwd_cuda.sizes[(n, c_in, c_out, h, w)] >= 1


def test_host_build_propagates_nans_where_the_dense_sums_do(on_host):
    """A NaN input: the forward's NaNs and codes are max_pool2d's; the wgrad's
    NaNs lie where the dense sums' do (it gathers the winners only, so the
    dense sums' 0 * NaN of the other positions are not there)."""
    x, w, b = stage_inputs(5, 1, 32, 64, 8)
    x[0, 3, 2, 5] = float('nan')
    y, code = fan_conv.fan_conv_fwd_cuda(x, w, b)
    y_p, code_p = fan_conv.fan_conv_fwd_plain(x, w, b)
    assert torch.equal(y.isnan(), y_p.isnan()) and bool(y.isnan().any())
    assert torch.equal(code, code_p)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    dw, _ = fan_conv.fan_conv_wgrad_cuda(dy, code, x)
    dw_p, _ = fan_conv.fan_conv_wgrad_plain(dy, code, x)
    assert bool(dw.isnan().any()) and bool((dw.isnan() <= dw_p.isnan()).all())
    finite = ~dw_p.isnan()
    assert relative(dw[finite], dw_p[finite]) < 1e-5
    np.testing.assert_array_equal(fan_conv.fan_conv_dgrad_cuda(dy, code, w).isnan().numpy(),
                                  fan_conv.fan_conv_dgrad_plain(dy, code, w).isnan().numpy())
