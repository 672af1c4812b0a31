"""
K2, K3 and K4: the fused soft-codebook quantizer and its backwards, and the
entropy of the quantized latent computed from codeword counts.

For each latent value the kernels make their passes over the L codewords
(the max and first argmax of the log kernel weight, and the
softmax-weighted sums), so no (N, L) weight matrix is built, forward or
backward. For L = 32, K2, K3 and K4 find the max at the nearest codeword
and make one pass with one log1p and one exp per codeword
(``csrc/codebook.cu`` says how); :func:`nearest_argmax_plain` is that rule in
plain PyTorch, for the tests.

- K2 :func:`codebook_fwd_cuda` → (soft value, hard index); replaces
  ``neural_imaging_tpu/ops/pallas/codebook.py::_kernel``.
- K3 :func:`codebook_bwd_cuda` → dz for a fixed codebook; replaces
  ``_bwd_kernel``.
- K4 :func:`codebook_bwd_train_cuda` → (dz, dcb) for a trainable codebook;
  replaces ``_bwd_train_kernel``.

All three are CUDA C++ (``csrc/codebook.cu``, built for sm_90a by
``_build``). Each has a plain PyTorch version with the same arithmetic, a
codeword loop over (N,) tensors (``*_plain``), and a dispatcher that takes
the plain version for a CPU tensor and the kernel for a CUDA tensor.

Around them, in plain PyTorch as in the reference: the per-codeword counts
(``torch.bincount`` of the hard indices), the O(L²) entropy epilogue (the
histogram of the quantized latent is (counts / N) @ W_cc, with W_cc the
weights of the codewords against each other), and the two VJPs of the
reference's ``jax.custom_vjp``s as ``torch.autograd.Function``s.
:func:`quantize_with_entropy_fused` is the entry point.
"""
import ctypes
import functools

import torch

from neural_imaging_tpu_torch.ops import quantization as quant

LIBRARY = 'codebook'
THREADS = 256                 # threads per block, as csrc/codebook.cu launches them
MAX_BLOCKS = 1024             # grid cap: a grid-stride loop covers larger N
MAX_CODES = 256               # codebook entries the kernels keep in shared memory
NEG_INF = -1e30               # pass 1's initial maximum, as in the reference


@functools.lru_cache()
def _library():
    from neural_imaging_tpu_torch.ops.hopper import _build
    lib = _build.load(LIBRARY)
    ptr, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.codebook_fwd.argtypes = [ptr, ptr, i32, i64, f64, f64, i32, ptr, ptr, i32, ptr]
    lib.codebook_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i64, f64, f64, i32, ptr, i32, ptr]
    lib.codebook_bwd_train.argtypes = [ptr, ptr, ptr, ptr, i32, i64, f64, f64, i32, ptr, ptr,
                                       ptr, i32, ptr]
    for fn in (lib.codebook_fwd, lib.codebook_bwd, lib.codebook_bwd_train):
        fn.restype = ctypes.c_int
    return lib


TRAIN_BLOCKS_PER_SM = 2       # K4's grid cap, kTrainBlocksPerSM: few rows of dcb sums


def _grid_blocks(n):
    """Blocks of ``THREADS`` that K2 and K3 launch for N values."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


@functools.lru_cache()
def _multiprocessors(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _train_blocks(n, device):
    """Blocks of ``THREADS`` that K4 launches for N values: at most
    ``TRAIN_BLOCKS_PER_SM`` per SM (as many as stay resident), so that its
    lanes keep their dcb sums across the grid-stride loop and the blocks
    leave few rows of partial sums."""
    return max(1, min(-(-n // THREADS), TRAIN_BLOCKS_PER_SM * _multiprocessors(device.index or 0)))


def _check(z, codebook, *others):
    """z and the (N,) others float32 1-D; codebook (L,) float32 with 1 <= L <= 256."""
    for t in (z, codebook, *others):
        if t.dtype != torch.float32:
            raise TypeError(f'codebook kernels take float32, got {t.dtype}')
        if t.ndim != 1:
            raise ValueError(f'codebook kernels take 1-D tensors, got {tuple(t.shape)}')
    if z.numel() == 0:
        raise ValueError('codebook kernels need at least one value')
    if not 1 <= codebook.numel() <= MAX_CODES:
        raise ValueError(f'codebook has {codebook.numel()} entries; 1 to {MAX_CODES} are supported')


def _check_cuda(name, tensors):
    device = tensors[0].device
    if device.type != 'cuda' or any(t.device != device for t in tensors):
        raise ValueError(f'{name} needs every input on one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} needs contiguous inputs')
    return device, torch.cuda.current_stream(device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed with CUDA error {err}')


# -- K2 ---------------------------------------------------------------------------

def codebook_fwd_cuda(z, codebook, v=50.0, gamma=25.0):
    """Launch K2 on CUDA tensors z (N,) and codebook (L,). Returns soft (N,)
    float32 and the hard (argmax) codeword index (N,) int32."""
    _check(z, codebook)
    device, stream = _check_cuda('codebook_fwd_cuda', (z, codebook))
    n, n_codes = z.numel(), codebook.numel()
    soft = torch.empty_like(z)
    hard = torch.empty(n, dtype=torch.int32, device=device)
    _raise_on(_library().codebook_fwd(z.data_ptr(), codebook.data_ptr(), n_codes, n,
                                      float(v), float(gamma), _grid_blocks(n), soft.data_ptr(),
                                      hard.data_ptr(), device.index or 0, stream),
              'codebook_fwd')
    codebook_fwd_cuda.launches += 1
    return soft, hard


codebook_fwd_cuda.launches = 0


def _scalar(value, like):
    """``value`` as a 0-d float32 tensor on ``like``'s device: dividing by it is
    a true division on the GPU too, where PyTorch multiplies by the
    reciprocal of a Python scalar divisor."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _logw(z, c, v, gamma, v_t):
    d = z - c
    if v <= 0:
        return -gamma * d * d
    gd = gamma * d
    return -(v + 1.0) / 2.0 * torch.log1p(gd * gd / v_t)


def _logw_dlogw(z, c, v, gamma, v_t):
    d = z - c
    if v <= 0:
        return -gamma * d * d, -2.0 * gamma * d
    gd = gamma * d
    t = gd * gd
    return -(v + 1.0) / 2.0 * torch.log1p(t / v_t), -(v + 1.0) * gamma * gd / (v_t + t)


def _argmax_pass(z, codebook, v, gamma, v_t):
    m = torch.full_like(z, NEG_INF)
    best = torch.zeros(z.shape, dtype=torch.int32, device=z.device)
    for j in range(codebook.numel()):
        lw = _logw(z, codebook[j], v, gamma, v_t)
        take = lw > m
        m = torch.where(take, lw, m)
        best = torch.where(take, j, best)
    return m, best


def nearest_argmax_plain(z, codebook, v=50.0, gamma=25.0):
    """The max log-weight and its first argmax by K2's, K3's and K4's rule for
    L = 32: the nearest codeword by the rounded |z - c| (the first on a tie)
    gives the trial max m, and the hard index is the first j with logw_j ==
    m; where some logw_j > m, none equals m or m is not above ``NEG_INF``,
    the value takes the two-pass rule (:func:`_argmax_pass`). Returns (m,
    best, the values that took the two-pass rule). For the tests: the same
    results as ``_argmax_pass`` whatever the codebook's order and ties."""
    v_t = _scalar(v, z)
    dist = torch.stack([(z - codebook[j]).abs() for j in range(codebook.numel())])
    nearest = torch.argmin(dist, dim=0)           # the first of equal minima
    m = _logw(z, codebook[nearest], v, gamma, v_t)
    best = torch.full(z.shape, codebook.numel(), dtype=torch.int32, device=z.device)
    above = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for j in reversed(range(codebook.numel())):
        lw = _logw(z, codebook[j], v, gamma, v_t)
        above |= lw > m
        best = torch.where(lw == m, j, best)
    slow = above | (best == codebook.numel()) | ~(m > NEG_INF)
    m_two, best_two = _argmax_pass(z, codebook, v, gamma, v_t)
    return torch.where(slow, m_two, m), torch.where(slow, best_two, best), slow


def _sums_pass(z, codebook, m, v, gamma, v_t):
    s, a, b, csum = (torch.zeros_like(z) for _ in range(4))
    for j in range(codebook.numel()):
        c = codebook[j]
        lw, dlw = _logw_dlogw(z, c, v, gamma, v_t)
        w = torch.exp(lw - m)
        s, a, b, csum = s + w, a + w * dlw, b + c * (w * dlw), csum + c * w
    return s, a, b, csum


def codebook_fwd_plain(z, codebook, v=50.0, gamma=25.0):
    """K2's arithmetic in plain PyTorch, one codeword at a time; same
    arguments and results as :func:`codebook_fwd_cuda`, on any device."""
    _check(z, codebook)
    v_t = _scalar(v, z)
    m, best = _argmax_pass(z, codebook, v, gamma, v_t)
    s, acc = torch.zeros_like(z), torch.zeros_like(z)
    for j in range(codebook.numel()):
        c = codebook[j]
        w = torch.exp(_logw(z, c, v, gamma, v_t) - m)
        s, acc = s + w, acc + w * c
    return acc / s, best


def codebook_fwd(z, codebook, v=50.0, gamma=25.0):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if z.device.type == 'cpu':
        return codebook_fwd_plain(z, codebook, v, gamma)
    return codebook_fwd_cuda(z, codebook, v, gamma)


# -- K3 ---------------------------------------------------------------------------

def codebook_bwd_cuda(z, g, codebook, per_codeword, v=50.0, gamma=25.0):
    """Launch K3: dz = (g + per_codeword[argmax] / N) · d soft / dz, for CUDA
    tensors z, g (N,) and codebook, per_codeword (L,)."""
    _check(z, codebook, g, per_codeword)
    device, stream = _check_cuda('codebook_bwd_cuda', (z, g, codebook, per_codeword))
    if g.numel() != z.numel() or per_codeword.numel() != codebook.numel():
        raise ValueError('codebook_bwd_cuda: g must match z and per_codeword the codebook')
    n = z.numel()
    dz = torch.empty_like(z)
    _raise_on(_library().codebook_bwd(z.data_ptr(), g.data_ptr(), codebook.data_ptr(),
                                      per_codeword.data_ptr(), codebook.numel(), n, float(v),
                                      float(gamma), _grid_blocks(n), dz.data_ptr(),
                                      device.index or 0, stream),
              'codebook_bwd')
    codebook_bwd_cuda.launches += 1
    return dz


codebook_bwd_cuda.launches = 0


def _dz_plain(z, g, codebook, per_codeword, v, gamma):
    """K3's arithmetic; also returns what K4's third pass reuses."""
    v_t = _scalar(v, z)
    m, best = _argmax_pass(z, codebook, v, gamma, v_t)
    s, a, b, csum = _sums_pass(z, codebook, m, v, gamma, v_t)
    gn = g + per_codeword[best] * (1.0 / z.numel())
    return gn * ((b - csum * (a / s)) / s), gn, m, s, csum / s, v_t


def codebook_bwd_plain(z, g, codebook, per_codeword, v=50.0, gamma=25.0):
    """K3's arithmetic in plain PyTorch; same arguments and result as
    :func:`codebook_bwd_cuda`, on any device."""
    _check(z, codebook, g, per_codeword)
    return _dz_plain(z, g, codebook, per_codeword, v, gamma)[0]


def codebook_bwd(z, g, codebook, per_codeword, v=50.0, gamma=25.0):
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if z.device.type == 'cpu':
        return codebook_bwd_plain(z, g, codebook, per_codeword, v, gamma)
    return codebook_bwd_cuda(z, g, codebook, per_codeword, v, gamma)


# -- K4 ---------------------------------------------------------------------------

def codebook_bwd_train_cuda(z, g, codebook, per_codeword, v=50.0, gamma=25.0):
    """Launch K4: K3's dz and the streaming half of the codebook cotangent,
    dcb_j = Σ_n gn_n · w_nj · (1 − dlogw_nj · (c_j − soft_n)) with
    gn = g + per_codeword[argmax] / N. Returns (dz (N,), dcb (L,))."""
    _check(z, codebook, g, per_codeword)
    device, stream = _check_cuda('codebook_bwd_train_cuda', (z, g, codebook, per_codeword))
    if g.numel() != z.numel() or per_codeword.numel() != codebook.numel():
        raise ValueError('codebook_bwd_train_cuda: g must match z and per_codeword the codebook')
    n, n_codes = z.numel(), codebook.numel()
    blocks = _train_blocks(n, device)
    dz = torch.empty_like(z)
    partial = torch.empty((blocks, n_codes), dtype=torch.float32, device=device)
    dcb = torch.empty_like(codebook)
    _raise_on(_library().codebook_bwd_train(
        z.data_ptr(), g.data_ptr(), codebook.data_ptr(), per_codeword.data_ptr(), n_codes, n,
        float(v), float(gamma), blocks, dz.data_ptr(), partial.data_ptr(), dcb.data_ptr(),
        device.index or 0, stream), 'codebook_bwd_train')
    codebook_bwd_train_cuda.launches += 1
    return dz, dcb


codebook_bwd_train_cuda.launches = 0


def codebook_bwd_train_plain(z, g, codebook, per_codeword, v=50.0, gamma=25.0):
    """K4's arithmetic in plain PyTorch; same arguments and results as
    :func:`codebook_bwd_train_cuda`, on any device."""
    _check(z, codebook, g, per_codeword)
    dz, gn, m, s, soft, v_t = _dz_plain(z, g, codebook, per_codeword, v, gamma)
    dcb = []
    for j in range(codebook.numel()):
        c = codebook[j]
        lw, dlw = _logw_dlogw(z, c, v, gamma, v_t)
        w = torch.exp(lw - m) / s
        dcb.append(torch.sum(gn * w * (1.0 - dlw * (c - soft))))
    return dz, torch.stack(dcb)


def codebook_bwd_train(z, g, codebook, per_codeword, v=50.0, gamma=25.0):
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if z.device.type == 'cpu':
        return codebook_bwd_train_plain(z, g, codebook, per_codeword, v, gamma)
    return codebook_bwd_train_cuda(z, g, codebook, per_codeword, v, gamma)


# -- O(L²) epilogues and the VJPs ---------------------------------------------------

def _codeword_weight_matrix(codebook, v, gamma):
    """W_cc[i, j]: normalized kernel weight of codeword i against codeword j."""
    return torch.softmax(quant.codebook_log_weights(codebook, codebook, v, gamma), dim=-1)


def _codeword_dlogw(codebook, v, gamma):
    """d logw(x, c_j) / dx at x = c_i, as an (L, L) matrix."""
    d = codebook[:, None] - codebook[None, :]
    if v <= 0:
        return -2.0 * gamma * d
    gd = gamma * d
    return -(v + 1.0) * gamma * gd / (v + gd * gd)


def _histogram(counts, n, w_cc):
    """Soft histogram of the quantized latent from its codeword counts:
    (clipped raw histogram, normalized histogram)."""
    raw = (counts / n) @ w_cc
    hist = torch.clamp(raw, min=1e-9)
    return raw, hist / torch.sum(hist)


def _entropy_bits(p):
    return -torch.sum(p * torch.log(p)) / quant.LN2


def _forward(z, codebook, v, gamma):
    """The shared forward: STE value, entropy, histogram, counts."""
    z_flat = z.reshape(-1).to(torch.float32).contiguous()
    soft, hard_idx = codebook_fwd(z_flat, codebook, v, gamma)
    counts = torch.bincount(hard_idx, minlength=codebook.numel()).to(torch.float32)
    hard = codebook[hard_idx]
    q = ((hard - soft) + soft).reshape(z.shape)
    _, histogram = _histogram(counts, z_flat.numel(), _codeword_weight_matrix(codebook, v, gamma))
    return q, _entropy_bits(histogram), histogram, counts


class _QuantizeWithEntropy(torch.autograd.Function):
    """Fixed codebook: gradient for z only, the reference's ``_bwd``. Its
    entropy path treats the histogram's clip and normalization as identity,
    as the reference's fused VJP does (not the autodiff of the plain
    composition)."""

    @staticmethod
    def forward(ctx, z, codebook, v, gamma):
        q, h, histogram, _ = _forward(z, codebook, v, gamma)
        ctx.save_for_backward(z, codebook, histogram)
        ctx.v, ctx.gamma = v, gamma
        return q, h, histogram

    @staticmethod
    def backward(ctx, g_q, g_h, g_hist):
        z, codebook, histogram = ctx.saved_tensors
        v, gamma = ctx.v, ctx.gamma
        g_hist_total = g_h * (-(torch.log(histogram) + 1.0) / quant.LN2) + g_hist
        w_cc = _codeword_weight_matrix(codebook, v, gamma)
        dlogw_cc = _codeword_dlogw(codebook, v, gamma)
        dw_cc = w_cc * (dlogw_cc - torch.sum(w_cc * dlogw_cc, dim=-1, keepdim=True))
        per_codeword = (dw_cc @ g_hist_total).contiguous()
        dz = codebook_bwd(z.reshape(-1).to(torch.float32).contiguous(),
                          g_q.reshape(-1).to(torch.float32).contiguous(), codebook,
                          per_codeword, v, gamma)
        return dz.reshape(z.shape), None, None, None


class _QuantizeWithEntropyTrainable(torch.autograd.Function):
    """Trainable codebook: gradients for z and the codebook, the reference's
    ``_bwd_trainable`` (the exact VJP of quantize → entropy of q). K4 gives dz
    and the Σ_n half of dcb; the entropy's explicit path through W_cc(cb) is
    an O(L²) epilogue."""

    @staticmethod
    def forward(ctx, z, codebook, v, gamma):
        q, h, histogram, counts = _forward(z, codebook, v, gamma)
        ctx.save_for_backward(z, codebook, counts)
        ctx.v, ctx.gamma = v, gamma
        return q, h, histogram

    @staticmethod
    def backward(ctx, g_q, g_h, g_hist):
        z, codebook, counts = ctx.saved_tensors
        v, gamma = ctx.v, ctx.gamma
        n = z.numel()
        w_cc = _codeword_weight_matrix(codebook, v, gamma)
        hist_raw, p = _histogram(counts, n, w_cc)
        hist = torch.clamp(hist_raw, min=1e-9)
        total = torch.sum(hist)
        # H = -Σ p log p / ln 2, p = hist / total, hist = clip(raw)
        gp = g_h * (-(torch.log(p) + 1.0) / quant.LN2) + g_hist
        ghist = (gp / total - torch.sum(gp * hist) / (total * total)) * (hist_raw > 1e-9)
        dlogw_cc = _codeword_dlogw(codebook, v, gamma)
        dw_cc = w_cc * (dlogw_cc - torch.sum(w_cc * dlogw_cc, dim=-1, keepdim=True))
        per_codeword = (dw_cc @ ghist).contiguous()
        dz, dcb_stream = codebook_bwd_train(
            z.reshape(-1).to(torch.float32).contiguous(),
            g_q.reshape(-1).to(torch.float32).contiguous(), codebook, per_codeword, v, gamma)
        # explicit entropy path through the codeword argument of w(q, cb)
        wg = w_cc @ ghist
        t = w_cc * dlogw_cc * (wg[:, None] - ghist[None, :])
        dcb = dcb_stream + (counts / n) @ t
        return dz.reshape(z.shape), dcb, None, None


def quantize_with_entropy_fused(z, codebook, v=50.0, gamma=25.0, trainable=False):
    """Soft-codebook quantization of ``z`` and the entropy (bits) of the
    quantized latent, through K2 forward and K3 (fixed codebook) or K4
    (``trainable=True``) backward. Same values as
    ``quantization.quantize_with_entropy(z, codebook, 'soft-codebook', v,
    gamma)``. Returns (quantized, entropy, histogram).

    ``codebook``: (L,) float32 on z's device; with ``trainable`` its gradient
    is computed (pass an ``nn.Parameter``)."""
    codebook = codebook.reshape(-1)
    if trainable:
        return _QuantizeWithEntropyTrainable.apply(z, codebook, float(v), float(gamma))
    return _QuantizeWithEntropy.apply(z, codebook.detach().contiguous(), float(v), float(gamma))


# -- agreement of two evaluations on the same inputs --------------------------------
#
# Two float32 evaluations of the same inputs (a kernel and its plain version,
# or the port and the JAX reference) agree as follows:
# - hard indices: equal except at near-ties of two log-weights, where the last
#   bit of log1p decides; at most MAX_INDEX_FLIP_SHARE of them may differ;
# - soft values: within L·ε·max|c|, the float32 error bound of the L-term
#   weighted sum Σ c_j w_j with Σ w_j = 1 (6.1e-5 for the DCN's 32 codewords
#   of magnitude <= 16);
# - dz and dcb: dz is (B − C·A/s)/s, a difference of two sums that cancel
#   wherever z sits near one codeword, and exp amplifies the last-bit error of
#   each log-weight by 1 + |logw − max|. So each entry is held to
#   BACKWARD_ULPS float32 epsilons of the float64 magnitude of the terms it is
#   summed from (backward_error_scale), 32 being the (L − 1)ε bound of an
#   L = 32-term sum. Port against the JAX kernels on the CPU: at most 8.3 ε
#   (dz) and 0.45 ε (dcb) of that scale (tests/test_torch_codebook.py shapes).
MAX_INDEX_FLIP_SHARE = 1e-4
BACKWARD_ULPS = 32
F32_EPS = float(torch.finfo(torch.float32).eps)


def backward_error_scale(z, g, codebook, per_codeword, v=50.0, gamma=25.0):
    """float64 magnitudes of the terms behind each dz (N,) and each dcb (L,),
    from (N, L) matrices: for checks at test and smoke-test sizes only."""
    c = codebook.double()
    d = z.double()[:, None] - c
    if v <= 0:
        lw, dlw = -gamma * d * d, -2.0 * gamma * d
    else:
        gd = gamma * d
        lw = -(v + 1.0) / 2.0 * torch.log1p(gd * gd / v)
        dlw = -(v + 1.0) * gamma * gd / (v + gd * gd)
    m, best = lw.max(dim=1)
    amp = 1.0 + (lw - m[:, None]).abs()
    w = torch.softmax(lw, dim=1)
    gn = (g.double() + per_codeword.double()[best] / z.numel()).abs()
    cw = c * w
    soft = cw.sum(dim=1)
    dz_scale = gn * (((cw * dlw).abs() * amp).sum(dim=1)
                     + soft.abs() * ((w * dlw).abs() * amp).sum(dim=1))
    dcb_scale = (gn[:, None] * w * amp
                 * (1.0 + dlw.abs() * (c.abs()[None, :] + soft.abs()[:, None]))).sum(dim=0)
    return dz_scale, dcb_scale


def check_forward(soft, hard, soft_ref, hard_ref, codebook):
    """Hold K2's results against a reference evaluation with the same
    codebook; raises AssertionError beyond the bounds above. Returns
    {'index_flips', 'n', 'max_abs_err'} (soft values, over all entries)."""
    flips = int((hard.long() != hard_ref.long()).sum())
    report = {'index_flips': flips, 'n': hard.numel(),
              'max_abs_err': float((soft.double() - soft_ref.double()).abs().max())}
    soft_atol = codebook.numel() * F32_EPS * float(codebook.abs().max())
    if flips > MAX_INDEX_FLIP_SHARE * hard.numel() or not report['max_abs_err'] <= soft_atol:
        raise AssertionError(f'codebook forward results disagree: {report}')
    return report


def check_backward(got, ref, scale, name='dz'):
    """Hold dz or dcb against a reference evaluation, entry by entry, at
    ``BACKWARD_ULPS`` epsilons of its ``scale`` (``backward_error_scale``).
    Returns {'max_abs_err', 'max_eps_of_scale'}; raises AssertionError beyond."""
    err = (got.double() - ref.double()).abs()
    ratio = err / (F32_EPS * scale.to(err.device) + 1e-300)
    report = {'max_abs_err': float(err.max()), 'max_eps_of_scale': float(ratio.max())}
    if not report['max_eps_of_scale'] <= BACKWARD_ULPS:
        raise AssertionError(f'codebook backward {name} disagrees: {report}')
    return report
