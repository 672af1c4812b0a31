"""The port's profiling, memory diagnostics and guarded fetch against the JAX
package's ``utils/profiling.py``, ``utils/debugging.py`` and
``utils/runtime.py``, on the CPU.

FLOPs and bytes: ``profiling.step_cost`` (PyTorch's ``FlopCounterMode`` and
the port's byte counter) against XLA's cost analysis of the same function,
exactly equal on a matrix product and a 'VALID' convolution; on a 'SAME'
convolution PyTorch counts the taps over the zero padding and XLA does not,
so the port's count exceeds XLA's by exactly those taps. The kernels'
registered operators are counted by their work functions, whose values are
the constants chip_smoke.py bounded the kernels by before they moved."""
import json
import threading
import time
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import flop_registry

from neural_imaging_tpu.utils import debugging as jdebugging
from neural_imaging_tpu.utils import profiling as jprofiling
from neural_imaging_tpu.utils import runtime as jruntime
from neural_imaging_tpu_torch.ops.hopper import codebook, fan_conv, jpeg8x8, registry
from neural_imaging_tpu_torch.utils import debugging, profiling, runtime
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)

torch.set_num_threads(1)


def conv_case(padding, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    w = rng.standard_normal((5, 5, 3, 4)).astype(np.float32)

    def jax_fn(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1), padding,
                                            dimension_numbers=('NHWC', 'HWIO', 'NHWC'))

    def torch_fn(x, w):
        return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                          padding=padding.lower())
    return jax_fn, torch_fn, x, w


def outside_taps(h, w, k):
    """The taps of a k x k 'SAME' window over an h x w image that fall on
    the padding, summed over the output pixels."""
    r = k // 2
    rows = np.arange(h)[:, None] + np.arange(k)[None, :] - r
    cols = np.arange(w)[:, None] + np.arange(k)[None, :] - r
    inside_rows = ((rows >= 0) & (rows < h)).sum(axis=1)
    inside_cols = ((cols >= 0) & (cols < w)).sum(axis=1)
    return h * w * k * k - int(inside_rows.sum() * inside_cols.sum())


@pytest.mark.parametrize('case', ['matmul', 'valid_conv'])
def test_step_cost_equals_xla_on_products_and_valid_convs(case):
    if case == 'matmul':
        a = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)
        got = profiling.step_cost(lambda x: x @ x, torch.from_numpy(a))
        want = jprofiling.step_cost(lambda x: x @ x, a)
    else:
        jax_fn, torch_fn, x, w = conv_case('VALID')
        got = profiling.step_cost(torch_fn, torch.from_numpy(x), torch.from_numpy(w))
        want = jprofiling.step_cost(jax_fn, x, w)
    assert got['flops'] == want['flops']
    assert got['bytes_accessed'] == want['bytes_accessed']
    assert got['flops_by_kernel'] == {}


def test_step_cost_of_a_same_conv_exceeds_xla_by_the_padding_taps():
    jax_fn, torch_fn, x, w = conv_case('SAME')
    got = profiling.step_cost(torch_fn, torch.from_numpy(x), torch.from_numpy(w))
    want = jprofiling.step_cost(jax_fn, x, w)
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    assert got['flops'] - want['flops'] == 2 * n * cin * cout * outside_taps(h, wd, k)
    assert got['bytes_accessed'] == want['bytes_accessed']


def test_step_cost_counts_a_training_step_with_its_backward():
    layer = torch.nn.Linear(32, 16)
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(2)).requires_grad_()
    forward = profiling.step_cost(lambda: layer(x))
    step = profiling.step_cost(lambda: layer(x).sum().backward())
    assert forward['flops'] == 2 * 8 * 32 * 16
    assert step['flops'] == 3 * forward['flops']       # and the dW and dx products
    assert step['bytes_accessed'] > forward['bytes_accessed']


def test_k1_on_the_cpu_counts_its_plain_versions_products():
    planes = torch.rand(6, 16, 24) * 255 - 127
    q = torch.full((6, 8, 8), 4.0)
    cost = profiling.step_cost(jpeg8x8.jpeg_core, planes, q)
    blocks = 6 * 16 * 24 // 64
    assert cost['flops'] == blocks * 4 * 2 * 8 ** 3    # four 8x8x8 products a block
    assert cost['flops_by_kernel'] == {}


def test_k2_on_the_cpu_counts_its_plain_versions_flops():
    z = torch.randn(300) * 4
    cb = torch.linspace(-15, 16, 32)
    cost = profiling.step_cost(codebook.codebook_fwd, z, cb)
    assert cost['flops'] == 0                        # elementwise: FlopCounterMode counts none
    assert cost['bytes_accessed'] > 0


# chip_smoke.py's constants before they moved to ops/hopper (sass_costs.py's counts)
OLD_LOG1P, OLD_EXP, OLD_DIV, OLD_EXP_APPROX, OLD_DIV_BY_V = 24, 7, 10, 2, 3
OLD_LOGW = 4 + OLD_DIV_BY_V + OLD_LOG1P
OLD_K2 = OLD_LOGW + 3 + 1 + OLD_EXP_APPROX + 2
OLD_K3 = OLD_LOGW + 3 + 1 + OLD_EXP + 2 + OLD_DIV + 5


@pytest.mark.parametrize('kernel', sorted(registry.OPS))
def test_registered_formulas_are_the_old_bounds(kernel):
    packet, work = registry.OPS[kernel]
    formula = flop_registry[packet]
    if kernel == 'jpeg8x8':
        p, h, w = 60, 256, 256
        shapes, old = ((p, h, w), (p, 8, 8)), ((4 * 16 + 3) * p * h * w,
                                                 4 * (3 * p * h * w + 64 * p + 64))
    elif kernel.startswith('fan_conv'):
        # K5 at conv1 of the m_quality FAN: the forward's dense products, the
        # backward's products with the gradient's nonzero quarter
        n, c_in, c_out, h, w = 100, 32, 64, 64, 64
        x, wt, pooled = (n, c_in, h, w), (c_out, c_in, 5, 5), (n, c_out, h // 2, w // 2)
        shapes = {'fan_conv_fwd': (x, wt, (c_out,)), 'fan_conv_dgrad': (pooled, pooled, wt),
                  'fan_conv_wgrad': (pooled, pooled, x)}[kernel]
        dense, quarter = 2 * n * h * w * c_in * c_out * 25, 2 * n * h * w * c_in * c_out * 25 // 4
        old = {'fan_conv_fwd': (dense, 4 * (n * c_in * h * w + c_out * c_in * 25 + c_out)
                                + 5 * n * c_out * h * w // 4),
               'fan_conv_dgrad': (quarter, 5 * n * c_out * h * w // 4 + 4 * c_out * c_in * 25
                                  + 4 * n * c_in * h * w),
               'fan_conv_wgrad': (quarter, 5 * n * c_out * h * w // 4 + 4 * n * c_in * h * w
                                  + 4 * (c_out * c_in * 25 + c_out))}[kernel]
    else:
        n, codes = 409_600, 32
        shapes = ((n,), (codes,)) if kernel == 'codebook_fwd' else ((n,), (n,), (codes,), (codes,))
        old = {'codebook_fwd': (n * (codes * OLD_K2 + OLD_DIV), 12 * n + 4 * codes),
               'codebook_bwd': (n * (codes * OLD_K3 + OLD_DIV + 5), 12 * n + 8 * codes),
               'codebook_bwd_train': (n * (codes * (OLD_K3 + 4) + OLD_DIV + 7),
                                      12 * n + 12 * codes)}[kernel]
    assert work(*shapes) == old
    assert formula(*[torch.empty(s, device='meta') for s in shapes], out_val=None) == old[0]


@pytest.mark.parametrize('kernel', sorted(registry.OPS))
def test_operators_fake_the_launchers_outputs(kernel):
    packet, _ = registry.OPS[kernel]
    if kernel == 'jpeg8x8':
        out = packet(torch.empty(3, 16, 24, device='meta'), torch.empty(3, 8, 8, device='meta'))
        assert [(t.shape, t.dtype) for t in out] == [((3, 16, 24), torch.float32)] * 2
        return
    if kernel.startswith('fan_conv'):
        x, w = torch.empty(5, 32, 16, 24, device='meta'), torch.empty(64, 32, 5, 5, device='meta')
        dy = torch.empty(5, 64, 8, 12, device='meta')
        code = torch.empty(5, 64, 8, 12, dtype=torch.uint8, device='meta')
        args = {'fan_conv_fwd': (x, w, torch.empty(64, device='meta')),
                'fan_conv_dgrad': (dy, code, w), 'fan_conv_wgrad': (dy, code, x)}[kernel]
        out = packet(*args)
        out = out if isinstance(out, tuple) else (out,)
        want = {'fan_conv_fwd': [((5, 64, 8, 12), torch.float32), ((5, 64, 8, 12), torch.uint8)],
                'fan_conv_dgrad': [((5, 32, 16, 24), torch.float32)],
                'fan_conv_wgrad': [((64, 32, 5, 5), torch.float32), ((64,), torch.float32)]}[kernel]
        assert [(tuple(t.shape), t.dtype) for t in out] == want
        return
    z, cb = torch.empty(777, device='meta'), torch.empty(32, device='meta')
    args = (z, cb) if kernel == 'codebook_fwd' else (z, z, cb, cb)
    out = packet(*args, 50.0, 25.0)
    out = out if isinstance(out, tuple) else (out,)
    want = {'codebook_fwd': [((777,), torch.float32), ((777,), torch.int32)],
            'codebook_bwd': [((777,), torch.float32)],
            'codebook_bwd_train': [((777,), torch.float32), ((32,), torch.float32)]}[kernel]
    assert [(tuple(t.shape), t.dtype) for t in out] == want


def test_operators_refuse_cpu_tensors():
    with pytest.raises(NotImplementedError):
        jpeg8x8.jpeg8x8_op(torch.zeros(3, 8, 8), torch.ones(3, 8, 8))


def test_op_traffic_ranks_the_product_first_with_its_exact_bytes():
    """As the reference's hlo_traffic test: the product ranks first and its
    bytes are its operands' and output's; the total is the sum of all the
    records."""
    x = torch.ones(256, 512)
    w = torch.ones(512, 128)
    records = profiling.op_traffic(lambda: torch.tanh(x @ w).sum(), top=100)
    assert records[0]['op'] == 'mm'
    assert records[0]['bytes'] == (256 * 512 + 512 * 128 + 256 * 128) * 4
    assert records[0]['out_bytes'] == 256 * 128 * 4
    assert records[0]['total_bytes'] == sum(r['bytes'] for r in records)
    assert records[0]['n_instructions'] == len(records) == 3
    assert set(records[0]) >= {'name', 'op', 'bytes', 'out_bytes', 'op_name'}
    assert records[0]['total_bytes'] == profiling.step_cost(
        lambda: torch.tanh(x @ w).sum())['bytes_accessed']


def test_op_traffic_names_the_module_of_each_call():
    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.ReLU())
    x = torch.ones(2, 8)
    records = profiling.op_traffic(lambda: torch.zeros(3) + model(x).sum(), top=10)
    assert {r['op']: r['op_name'] for r in records} == {
        'addmm': 'Sequential.0', 'relu': 'Sequential.1', 'zeros': '', 'sum': '', 'add': ''}
    assert len(profiling.op_traffic(lambda: model(x), top=1)) == 1


def test_compiled_stats_has_the_costs_and_sizes():
    a = torch.ones(64, 64)
    stats = profiling.compiled_stats(lambda x: x @ x, a)
    want = jprofiling.compiled_stats(lambda x: x @ x, jnp.ones((64, 64)))
    assert stats['flops'] == want['flops']
    assert stats['argument_size_bytes'] == stats['output_size_bytes'] == 64 * 64 * 4
    assert 'temp_size_bytes' not in stats          # measured on a card only


def test_scalar_log_writes_the_reference_bytes(tmp_path):
    records = [(0, {'loss': 1.5}), (1, {'loss': np.float64(1.2), 'acc': np.float32(0.7)}),
               (2, {'loss': 0.1 + 0.2, 'lr': 1e-4})]
    ours, ref = tmp_path / 'ours' / 'scalars.jsonl', tmp_path / 'ref' / 'scalars.jsonl'
    for cls, path in ((profiling.ScalarLog, ours), (jprofiling.ScalarLog, ref)):
        log = cls(str(path))
        for step, scalars in records:
            log.log(step, **scalars)
        log.close()
    assert ours.read_bytes() == ref.read_bytes()
    log = profiling.ScalarLog(str(ours))
    log.log(3, loss=torch.tensor(2.5))
    log.close()
    assert profiling.ScalarLog.read(str(ours))[-1] == {'step': 3, 'loss': 2.5}
    assert profiling.ScalarLog.read(str(ours))[:3] == jprofiling.ScalarLog.read(str(ref))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / 'trace')) as log_dir:
        torch.ones(16, 16) @ torch.ones(16, 16)
    with open(tmp_path / 'trace' / 'trace.json') as f:
        assert 'traceEvents' in json.load(f)
    assert log_dir == str(tmp_path / 'trace')


def test_chip_peaks_and_utilization(monkeypatch):
    assert profiling.chip_peaks('cpu') == (None, None)
    assert profiling.utilization(1e12, 1e9, 0.01, 'cpu') == {}
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: 'NVIDIA H100 80GB HBM3')
    assert profiling.chip_peaks(torch.device('cuda', 0)) == (989.4e12, 3.35e12)
    assert profiling.chip_peaks(0) == (989.4e12, 3.35e12)
    util = profiling.utilization(4e11, 2e9, 0.02, torch.device('cuda', 0))
    # the reference's formula against the same peaks
    monkeypatch.setattr(jprofiling, 'chip_peaks', lambda device=None: (989.4e12, 3.35e12))
    assert util == jprofiling.utilization(4e11, 2e9, 0.02)
    assert util['mfu'] == pytest.approx(4e11 / 0.02 / 989.4e12)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: 'NVIDIA H100 PCIe')
    assert profiling.chip_peaks(0) == (756e12, 2.0e12)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: 'NVIDIA A100')
    assert profiling.chip_peaks(0) == (None, None)


def test_memory_probes_as_the_reference():
    assert debugging.memory_usage_resource() > 1
    assert debugging.memory_usage_proc() > 1
    assert debugging.memory_usage_psutil() > 1
    a = np.zeros((1024, 1024), np.float32)
    assert debugging.array_megabytes(a) == jdebugging.array_megabytes(a) == 4.0
    assert debugging.array_megabytes(torch.zeros(1024, 512, dtype=torch.float64)) == 4.0
    assert debugging.array_megabytes([[1.0, 2.0]]) == jdebugging.array_megabytes([[1.0, 2.0]])


def test_device_memory_without_a_card_is_empty():
    keep = torch.ones(128, 128)
    assert debugging.device_memory_stats() == {}
    assert debugging.live_device_arrays() == {}
    del keep


def test_live_device_arrays_counts_cuda_tensors(monkeypatch):
    """The gc walk keeps the tensors on a CUDA device (faked: is_cuda)."""
    fake = types.SimpleNamespace(is_cuda=True, device='cuda:0', numel=lambda: 262144,
                                 element_size=lambda: 4)
    keep = [fake, torch.ones(4)]
    monkeypatch.setattr(torch, 'is_tensor', lambda obj: obj is fake or isinstance(obj, torch.Tensor))
    totals = debugging.live_device_arrays()
    assert totals == {'cuda:0': (1, 1.0)}
    del keep


def test_fetch_with_timeout_returns_the_value():
    v = runtime.fetch_with_timeout(torch.arange(4.0), timeout_s=30.0)
    assert v is not None and v.shape == (4,) and v[3] == 3.0
    ref = jruntime.fetch_with_timeout(jnp.arange(4.0), timeout_s=30.0)
    np.testing.assert_array_equal(v, ref)
    np.testing.assert_array_equal(runtime.fetch_with_timeout(np.ones(3)), np.ones(3))


def test_fetch_with_timeout_gives_none_past_the_deadline():
    release = threading.Event()

    class Stalled:
        def __array__(self, dtype=None, copy=None):
            release.wait(10)
            return np.zeros(2)

    t0 = time.perf_counter()
    assert runtime.fetch_with_timeout(Stalled(), timeout_s=0.2) is None
    assert time.perf_counter() - t0 < 5
    release.set()


@pytest.mark.parametrize('case', ['finite', 'nan', 'timeout'])
def test_assert_finite_with_a_deadline(case, monkeypatch):
    flow = types.SimpleNamespace(_finite_flags=[torch.tensor(True), torch.tensor(case != 'nan')])
    if case == 'timeout':
        monkeypatch.setattr(runtime, 'fetch_with_timeout', lambda value, timeout_s: None)
        with pytest.warns(UserWarning, match='timed out'):
            ManipulationClassification.assert_finite(flow, timeout_s=0.5)
    elif case == 'nan':
        with pytest.raises(RuntimeError, match='NaNs'):
            ManipulationClassification.assert_finite(flow, timeout_s=5.0)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter('error')
            ManipulationClassification.assert_finite(flow, timeout_s=5.0)
    assert flow._finite_flags == []
