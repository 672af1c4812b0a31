"""
K5: a FAN conv stage, ``max_pool2x2(leaky_relu(conv5x5_SAME(x, W) + b, 0.2))``,
fused in float32, and its backward (``csrc/fan_conv.cu``).

- :func:`fan_conv_fwd_cuda` → (pooled output, code): the code, one uint8 a
  pooled output, holds the window position that won (bits 0-1, row-major) and
  whether its pre-activation was >= 0 (bit 2). The full-resolution
  activation never reaches device memory.
- :func:`fan_conv_dgrad_cuda` → dx from the pooled gradient, the code and W.
- :func:`fan_conv_wgrad_cuda` → (dW, db) from the pooled gradient, the code
  and the stage's input, gathered at the winning positions (the other three
  quarters of the full-resolution gradient are exact zeros).

It replaces no TPU kernel: the JAX package leaves the FAN's convolutions to
XLA. Each has a plain PyTorch version (``*_plain``: the conv, the activation
and the max-pool as PyTorch composes them, and their gradients through the
expanded gradient), a registered operator (``torch.ops.neural_imaging_tpu_torch.
fan_conv_fwd``, ``fan_conv_dgrad``, ``fan_conv_wgrad``: ``registry``), a work
function (``*_work``: one launch's least operations and bytes) and a
dispatcher that takes the plain version for a CPU tensor and the operator for
a CUDA tensor. Each launcher counts its launches (``launches``) and the
launches by (N, Cin, Cout, H, W) (``sizes``). :func:`fan_conv_stage` is the
differentiable stage, :func:`supports` the widths the kernels take.
"""
import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from neural_imaging_tpu_torch.ops.hopper import registry

LIBRARY = 'fan_conv'
KERNEL = 5                    # the kernels' conv size
SLOPE = 0.2                   # the leaky ReLU's negative slope (0.2f in the kernels)


def supports(c_in, c_out, kernel=KERNEL):
    """Whether the kernels take a stage of these widths: a 5x5 conv from 3
    channels to a multiple of 32, or from a multiple of 32 to a multiple of
    64 (the FAN's stages: 3 → 32 and each next one doubling)."""
    return (kernel == KERNEL and c_out > 0
            and (c_out % 32 == 0 if c_in == 3 else c_in > 0 and c_in % 32 == 0
                 and c_out % 64 == 0))


def bind(lib):
    """Set the argument and result types of K5's C functions on ``lib`` (a
    ``ctypes.CDLL`` of ``csrc/fan_conv.cu``); returns it."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fan_conv_forward.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.fan_conv_dgrad.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.fan_conv_wgrad_splits.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    lib.fan_conv_wgrad.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    for fn in (lib.fan_conv_forward, lib.fan_conv_dgrad, lib.fan_conv_wgrad_splits,
               lib.fan_conv_wgrad):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache()
def _library():
    from neural_imaging_tpu_torch.ops.hopper import _build
    return bind(_build.load(LIBRARY))


# -- the work of one launch -----------------------------------------------------------
#
# The least that these inputs need, whatever implements them. The forward's
# products are dense: 2 N H W Cin Cout 25. The dgrad's and the wgrad's are
# those with the nonzero quarter of the full-resolution gradient, whose zeros
# are structural: 2 N (H/2) (W/2) Cin Cout 25. Bytes: each input read once,
# each output written once (4 a float, 1 a code).

def fan_conv_fwd_work(x_shape, w_shape, b_shape=None):
    """(operations, bytes) of one forward launch."""
    n, c_in, h, w = x_shape
    c_out = w_shape[0]
    pooled = n * c_out * (h // 2) * (w // 2)
    return (2 * n * h * w * c_in * c_out * KERNEL * KERNEL,
            4 * (n * c_in * h * w + c_out * c_in * KERNEL * KERNEL + c_out) + 5 * pooled)


def fan_conv_dgrad_work(dy_shape, code_shape, w_shape):
    """(operations, bytes) of one dgrad launch."""
    n, c_out, hp, wp = dy_shape
    c_in = w_shape[1]
    return (2 * n * hp * wp * c_in * c_out * KERNEL * KERNEL,
            5 * n * c_out * hp * wp + 4 * c_out * c_in * KERNEL * KERNEL
            + 4 * n * c_in * 4 * hp * wp)


def fan_conv_wgrad_work(dy_shape, code_shape, x_shape):
    """(operations, bytes) of one wgrad launch."""
    n, c_out, hp, wp = dy_shape
    c_in = x_shape[1]
    return (2 * n * hp * wp * c_in * c_out * KERNEL * KERNEL,
            5 * n * c_out * hp * wp + 4 * n * c_in * 4 * hp * wp
            + 4 * (c_out * c_in * KERNEL * KERNEL + c_out))


# -- checks -------------------------------------------------------------------------

def _check_float(name, *tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f'{name} takes float32, got {t.dtype}')


def _check_device(name, tensors):
    device = tensors[0].device
    if device.type != 'cuda' or any(t.device != device for t in tensors):
        raise ValueError(f'{name} needs every input on one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} needs contiguous inputs')
    return device, torch.cuda.current_stream(device).cuda_stream


def _check_sides(name, h, w):
    if h < 2 or w < 2 or h % 2 or w % 2:
        raise ValueError(f'{name} takes even sides, got {h}x{w}')


def _check_weight(name, w, c_in):
    if w.ndim != 4 or tuple(w.shape[2:]) != (KERNEL, KERNEL):
        raise ValueError(f'{name} takes a {KERNEL}x{KERNEL} kernel, got {tuple(w.shape)}')
    if w.shape[1] != c_in or not supports(c_in, w.shape[0]):
        raise ValueError(f'{name} takes 3 input channels to a multiple of 32, or a multiple '
                         f'of 32 to a multiple of 64, got {tuple(w.shape)} for {c_in} channels')


def _check_input(name, x):
    if x.ndim != 4:
        raise ValueError(f'{name} takes an NCHW batch, got {tuple(x.shape)}')
    _check_sides(name, x.shape[2], x.shape[3])
    if x.data_ptr() % 8:
        raise ValueError(f'{name} needs an 8-byte aligned input')


def _check_pooled(name, dy, code, c_out):
    if dy.ndim != 4 or dy.shape[1] != c_out or code.shape != dy.shape:
        raise ValueError(f'{name}: dy and code must be (N, {c_out}, H/2, W/2) alike, got '
                         f'{tuple(dy.shape)} and {tuple(code.shape)}')
    if code.dtype != torch.uint8:
        raise TypeError(f'{name} takes uint8 codes, got {code.dtype}')


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed with CUDA error {err}')


# -- forward ------------------------------------------------------------------------

def fan_conv_fwd_cuda(x, w, b):
    """Launch the forward on CUDA tensors x (N, Cin, H, W), w (Cout, Cin, 5, 5)
    and b (Cout,). Returns the pooled output (N, Cout, H/2, W/2) float32 and
    its code, uint8 of the same shape."""
    name = 'fan_conv_fwd_cuda'
    _check_float(name, x, w, b)
    _check_input(name, x)
    _check_weight(name, w, x.shape[1])
    if b.shape != (w.shape[0],):
        raise ValueError(f'{name}: the bias must be ({w.shape[0]},), got {tuple(b.shape)}')
    device, stream = _check_device(name, (x, w, b))
    n, c_in, h, wd = x.shape
    c_out = w.shape[0]
    taps = torch.empty(c_in * KERNEL * KERNEL * c_out, dtype=torch.float32, device=device)
    y = torch.empty((n, c_out, h // 2, wd // 2), dtype=torch.float32, device=device)
    code = torch.empty(y.shape, dtype=torch.uint8, device=device)
    _raise_on(_library().fan_conv_forward(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                          taps.data_ptr(), y.data_ptr(), code.data_ptr(), n, c_in,
                                          c_out, h, wd, device.index or 0, stream),
              'fan_conv_forward')
    fan_conv_fwd_cuda.launches += 1
    fan_conv_fwd_cuda.sizes[(n, c_in, c_out, h, wd)] += 1
    return y, code


fan_conv_fwd_cuda.launches = 0
fan_conv_fwd_cuda.sizes = collections.Counter()     # launches by (N, Cin, Cout, H, W)


def fan_conv_fwd_plain(x, w, b):
    """The forward in plain PyTorch: F.conv2d, F.leaky_relu and F.max_pool2d,
    the code from the pool's indices; same arguments and results as
    :func:`fan_conv_fwd_cuda`, on any device."""
    v = F.conv2d(x, w, b, padding=KERNEL // 2)
    y, index = F.max_pool2d(F.leaky_relu(v, SLOPE), 2, 2, return_indices=True)
    at = index // v.shape[-1] % 2 * 2 + index % 2
    v_win = v.flatten(2).gather(2, index.flatten(2)).view_as(y)
    return y, (at + 4 * (v_win >= 0)).to(torch.uint8)


def _fwd_launch(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return fan_conv_fwd_cuda(x, w, b)


def _fwd_fake(x, w, b):
    n, _, h, wd = x.shape
    shape = (n, w.shape[0], h // 2, wd // 2)
    return (torch.empty(shape, dtype=torch.float32, device=x.device),
            torch.empty(shape, dtype=torch.uint8, device=x.device))


fan_conv_fwd_op = registry.register('fan_conv_fwd', _fwd_launch, _fwd_fake, fan_conv_fwd_work)


def fan_conv_fwd(x, w, b):
    """The forward on a CUDA tensor (its operator), its plain version on a CPU tensor."""
    if x.device.type == 'cpu':
        return fan_conv_fwd_plain(x, w, b)
    return fan_conv_fwd_op(x, w, b)


# -- backward -----------------------------------------------------------------------

def expand_gradient(dy, code):
    """The gradient of the stage's pre-activation (N, C, H, W) from the pooled
    gradient and the code: dy at each window's winner, times the slope where
    its pre-activation was negative, and 0 at the other three positions."""
    g = torch.where((code & 4) != 0, dy, dy * SLOPE)
    at = code & 3
    n, c, hp, wp = dy.shape
    full = torch.stack([torch.where(at == k, g, torch.zeros_like(g)) for k in range(4)], -1)
    return full.view(n, c, hp, wp, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(n, c, 2 * hp, 2 * wp)


def fan_conv_dgrad_cuda(dy, code, w):
    """Launch the dgrad on CUDA tensors dy (N, Cout, H/2, W/2), its code and w
    (Cout, Cin, 5, 5). Returns dx (N, Cin, H, W) float32."""
    name = 'fan_conv_dgrad_cuda'
    _check_float(name, dy, w)
    _check_weight(name, w, w.shape[1] if w.ndim == 4 else 0)
    _check_pooled(name, dy, code, w.shape[0])
    device, stream = _check_device(name, (dy, code, w))
    n, c_out, hp, wp = dy.shape
    c_in = w.shape[1]
    taps = torch.empty(c_out * KERNEL * KERNEL * (4 if c_in == 3 else c_in), dtype=torch.float32,
                       device=device)
    dx = torch.empty((n, c_in, 2 * hp, 2 * wp), dtype=torch.float32, device=device)
    _raise_on(_library().fan_conv_dgrad(dy.data_ptr(), code.data_ptr(), w.data_ptr(),
                                        taps.data_ptr(), dx.data_ptr(), n, c_in, c_out, 2 * hp,
                                        2 * wp, device.index or 0, stream), 'fan_conv_dgrad')
    fan_conv_dgrad_cuda.launches += 1
    fan_conv_dgrad_cuda.sizes[(n, c_in, c_out, 2 * hp, 2 * wp)] += 1
    return dx


fan_conv_dgrad_cuda.launches = 0
fan_conv_dgrad_cuda.sizes = collections.Counter()   # launches by (N, Cin, Cout, H, W)


def fan_conv_dgrad_plain(dy, code, w):
    """The dgrad in plain PyTorch: the conv's input gradient of the expanded
    gradient; same arguments and result as :func:`fan_conv_dgrad_cuda`."""
    n, _, hp, wp = dy.shape
    return torch.nn.grad.conv2d_input((n, w.shape[1], 2 * hp, 2 * wp), w,
                                      expand_gradient(dy, code), padding=KERNEL // 2)


def _dgrad_launch(dy: torch.Tensor, code: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return fan_conv_dgrad_cuda(dy, code, w)


def _dgrad_fake(dy, code, w):
    n, _, hp, wp = dy.shape
    return torch.empty((n, w.shape[1], 2 * hp, 2 * wp), dtype=torch.float32, device=dy.device)


fan_conv_dgrad_op = registry.register('fan_conv_dgrad', _dgrad_launch, _dgrad_fake,
                                      fan_conv_dgrad_work)


def fan_conv_dgrad(dy, code, w):
    """The dgrad on a CUDA tensor (its operator), its plain version on a CPU tensor."""
    if dy.device.type == 'cpu':
        return fan_conv_dgrad_plain(dy, code, w)
    return fan_conv_dgrad_op(dy, code, w)


@functools.lru_cache(maxsize=64)
def _wgrad_splits(n, c_in, c_out, h, w, device_index):
    splits = ctypes.c_int(0)
    _raise_on(_library().fan_conv_wgrad_splits(n, c_in, c_out, h, w, device_index,
                                               ctypes.byref(splits)), 'fan_conv_wgrad_splits')
    return splits.value


def fan_conv_wgrad_cuda(dy, code, x):
    """Launch the wgrad on CUDA tensors dy (N, Cout, H/2, W/2), its code and
    the stage's input x (N, Cin, H, W). Returns dW (Cout, Cin, 5, 5) and db
    (Cout,), float32: the sums over the winning positions, in a fixed order."""
    name = 'fan_conv_wgrad_cuda'
    _check_float(name, dy, x)
    _check_input(name, x)
    n, c_in, h, wd = x.shape
    c_out = dy.shape[1] if dy.ndim == 4 else 0
    if not supports(c_in, c_out):
        raise ValueError(f'{name} takes 3 input channels to a multiple of 32, or a multiple '
                         f'of 32 to a multiple of 64, got {c_in} and {c_out}')
    _check_pooled(name, dy, code, c_out)
    if tuple(dy.shape) != (n, c_out, h // 2, wd // 2):
        raise ValueError(f'{name}: dy {tuple(dy.shape)} does not pool x {tuple(x.shape)}')
    device, stream = _check_device(name, (dy, code, x))
    splits = _wgrad_splits(n, c_in, c_out, h, wd, device.index or 0)
    partial = torch.empty((splits, c_out * c_in * KERNEL * KERNEL + c_out), dtype=torch.float32,
                          device=device)
    dw = torch.empty((c_out, c_in, KERNEL, KERNEL), dtype=torch.float32, device=device)
    db = torch.empty((c_out,), dtype=torch.float32, device=device)
    _raise_on(_library().fan_conv_wgrad(dy.data_ptr(), code.data_ptr(), x.data_ptr(),
                                        partial.data_ptr(), dw.data_ptr(), db.data_ptr(), n, c_in,
                                        c_out, h, wd, splits, device.index or 0, stream),
              'fan_conv_wgrad')
    fan_conv_wgrad_cuda.launches += 1
    fan_conv_wgrad_cuda.sizes[(n, c_in, c_out, h, wd)] += 1
    return dw, db


fan_conv_wgrad_cuda.launches = 0
fan_conv_wgrad_cuda.sizes = collections.Counter()   # launches by (N, Cin, Cout, H, W)


def fan_conv_wgrad_plain(dy, code, x):
    """The wgrad in plain PyTorch: the conv's weight gradient of the expanded
    gradient and its sum; same arguments and results as
    :func:`fan_conv_wgrad_cuda`."""
    full = expand_gradient(dy, code)
    dw = torch.nn.grad.conv2d_weight(x, (dy.shape[1], x.shape[1], KERNEL, KERNEL), full,
                                     padding=KERNEL // 2)
    return dw, full.sum(dim=(0, 2, 3))


def _wgrad_launch(dy: torch.Tensor, code: torch.Tensor,
                  x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return fan_conv_wgrad_cuda(dy, code, x)


def _wgrad_fake(dy, code, x):
    c_out, c_in = dy.shape[1], x.shape[1]
    return (torch.empty((c_out, c_in, KERNEL, KERNEL), dtype=torch.float32, device=dy.device),
            torch.empty((c_out,), dtype=torch.float32, device=dy.device))


fan_conv_wgrad_op = registry.register('fan_conv_wgrad', _wgrad_launch, _wgrad_fake,
                                      fan_conv_wgrad_work)


def fan_conv_wgrad(dy, code, x):
    """The wgrad on a CUDA tensor (its operator), its plain version on a CPU tensor."""
    if dy.device.type == 'cpu':
        return fan_conv_wgrad_plain(dy, code, x)
    return fan_conv_wgrad_op(dy, code, x)


# -- the differentiable stage ---------------------------------------------------------

class _FanConvStage(torch.autograd.Function):
    """The stage with its backward as the dgrad and wgrad launches. It saves
    the stage's input, W and the code: nothing at full resolution."""

    @staticmethod
    def forward(ctx, x, w, b):
        y, code = fan_conv_fwd(x, w, b)
        ctx.save_for_backward(x, w, code)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, code = ctx.saved_tensors
        dy = dy.contiguous()
        dx = fan_conv_dgrad(dy, code, w) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = fan_conv_wgrad(dy, code, x)
        return dx, dw, db


def fan_conv_stage(x, w, b):
    """``max_pool2x2(leaky_relu(conv5x5_SAME(x, w) + b, 0.2))`` of an NCHW
    float32 batch through K5 (on a CUDA tensor) or its plain version (on a CPU
    tensor), differentiable in x, w and b. The kernels take NCHW-contiguous
    tensors: another layout (a channels-last conv's output) is copied."""
    return _FanConvStage.apply(x.contiguous(), w.contiguous(), b.contiguous())
