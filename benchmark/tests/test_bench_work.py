"""The yardstick's arithmetic at known shapes: K1-K4's frozen work, the
bounds they give on the H100, the reference's FLOP count, and the roofline
reader, which cannot pass 100% where a launch takes its bound or longer."""
import collections

import pytest
import torch

from benchmark import run, work
from benchmark.metrics import hand_kernel_roofline
from benchmark.reference import fan

H100 = work.PEAKS['NVIDIA H100 80GB HBM3']


def test_k1_is_twelve_bytes_a_pixel_plus_the_tables():
    ops, nbytes = work.k1(60, 256, 256)
    assert ops == 67 * 60 * 256 * 256
    assert nbytes == 12 * 60 * 256 * 256 + 4 * 64 * 60 + 4 * 64
    # the main path's two launches a step: P=60 256² and P=300 128², bound by bytes
    both = work.bound_s(work.k1(60, 256, 256), H100) + work.bound_s(work.k1(300, 128, 128), H100)
    assert both == pytest.approx(31.7e-6, abs=0.05e-6)


@pytest.mark.parametrize('kernel,per_pair,per_value,out_bytes', [
    (work.k2, 13, 1, 4 * 32), (work.k3, 22, 7, 8 * 32), (work.k4, 27, 8, 12 * 32)])
def test_codebook_kernels(kernel, per_pair, per_value, out_bytes):
    n = 409_600
    ops, nbytes = kernel(n)
    assert ops == n * (32 * per_pair + per_value)
    assert nbytes == 12 * n + out_bytes
    # bound by operations at this N: the float32 rate, not the memory's
    assert work.bound_s((ops, nbytes), H100) == ops / H100['f32_flops']


def test_reference_flops_of_the_classifier():
    shapes = fan.leaf_shapes(5, n_filters=8, n_convolutions=2)
    leaves = fan.draw(shapes, torch.Generator().manual_seed(0), 'cpu')
    x = torch.rand(2, 3, 16, 16)
    # 2 FLOPs a multiply-add: the constrained 5x5 (3→3), conv0 5x5 (3→8) at
    # 16², conv1 5x5 (8→16) at 8², the 1x1 projection (16→16) at 4², the head
    expected = 2 * 2 * (16 * 16 * 3 * 3 * 25 + 16 * 16 * 8 * 3 * 25 + 8 * 8 * 16 * 8 * 25
                        + 4 * 4 * 16 * 16 + 16 * 5)
    assert run.count_flops(lambda: fan.fan(x, leaves, n_convolutions=2)) == expected


def test_roofline_reader_reads_at_most_100_at_the_bound():
    launches = {'k1': collections.Counter({(60, 256, 256): 3}),
                'k2': collections.Counter({409_600: 2})}
    at_bound = {'k1': {(60, 256, 256): 1e3 * work.bound_s(work.k1(60, 256, 256), H100)},
                'k2': {409_600: 1e3 * work.bound_s(work.k2(409_600), H100)}}
    ctx = run.Context(launches=launches, kernel_ms=at_bound, peaks=H100, codes=32)
    assert hand_kernel_roofline.read(ctx) == pytest.approx(100.0)
    ctx.kernel_ms = {k: {s: 2 * v for s, v in d.items()} for k, d in at_bound.items()}
    assert hand_kernel_roofline.read(ctx) == pytest.approx(50.0)
    assert hand_kernel_roofline.read(run.Context(launches=launches, peaks=H100)) is None
