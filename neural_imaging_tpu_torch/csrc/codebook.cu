// Fused soft-codebook quantizer (K2) and its two backwards (K3: fixed
// codebook, K4: trainable codebook) for Hopper (sm_90a).
//
// For every latent value x and every codeword c_j of an L-entry codebook
// (L <= 256), the log kernel weight is
//     t-Student (v > 0):  lw_j = -(v + 1)/2 * log1p((gamma (x - c_j))^2 / v)
//     Gaussian (v <= 0):  lw_j = -gamma (x - c_j)^2
// and w_j = softmax_j(lw). The hard index is the first j of the largest lw_j
// (strict >, the first codeword wins a tie), the soft value sum_j w_j c_j.
// The (N, L) weight matrix never exists in memory:
//   K2 (codebook_fwd)   soft and hard index.
//   K3 (codebook_bwd)   dz = (g + pc[hard]/N) (B - C A/s)/s from four sums
//                       s = sum w~, A = sum w~ dlw, B = sum c w~ dlw,
//                       C = sum c w~ (w~ = exp(lw - max), dlw = d lw / dx).
//   K4 (codebook_bwd_train) K3's dz and the codebook cotangent
//                       dcb_j = sum_n gn w_nj (1 - dlw_nj (c_j - soft_n)).
//
// Replaces the TPU kernels of neural_imaging_tpu/ops/pallas/codebook.py:
// _kernel (K2), _bwd_kernel (K3) and _bwd_train_kernel (K4). Those stream
// (8, 128) tiles through VMEM over a sequential grid, read the codebook from
// SMEM, pad N up to whole tiles with cb[0], and K4 carries dcb in a (1, L)
// output that the sequential grid revisits. Here one thread takes one value
// at a time (grid-stride loop), the codebook sits in shared memory and the
// ragged edge is masked instead of padded.
//
// Bound: operations. Per value and codeword each function needs one
// log1pf of the correctly rounded (gamma d)^2 / v (the hard index must
// agree with the plain version bit for bit), one exp and, for K3 and K4,
// dlw's division: at L = 32 some 1,250 (K2) to 2,000 (K4) SASS instructions
// for 12 bytes of memory traffic, far above the H100's ~10
// instructions/byte ridge (chip_smoke.py states the count, with the costs
// that sass_costs.py measures).
//
// K2, K3 and K4 (the design of this file for them):
// - The maximum needs no transcendental: both weight kernels fall
//   monotonically with |x - c|, so the nearest codeword (by the rounded
//   |x - c|, which is monotone in the exact distance) holds the largest
//   log-weight m. One pass over j then computes lw_j, w~_j = exp(lw_j - m),
//   the sums and the first j with lw_j == m, which is the first argmax: one
//   log1pf and one exp per value and codeword (at L = 32). If some lw_j > m
//   (log1pf is not proven monotone in its last bit), no lw_j equals m or
//   the value is outside the fast forms' range, the value takes the two
//   passes of the first design (max and first argmax, then the sums, all
//   accurate), so the hard index is that of the two-pass rule in every
//   case.
// - L = 32, the L of every shipped codec, is a template argument: the
//   codeword loops unroll, the first argmax comes from a bit mask, t / v
//   from the reciprocal of v (Weights::div_v, the IEEE quotient's bits),
//   and K4 keeps w~_j and dlw_j of the value in registers for its codebook
//   pass. K2 takes its weights' exp as ex2.approx (its soft value is held
//   to an absolute tolerance); K3 and K4 keep the accurate expf and IEEE
//   divisions, in the plain version's order, because check_backward holds
//   each dz and dcb_j to its own terms' scale, which for a dcb_j of a
//   codeword far from every value lies in the subnormal range. Other L (up to 256) take the
//   two passes of the first design with runtime loops, and K4 evaluates
//   lw_j and dlw_j again for its codebook pass there.
// - K4 reduces dcb without atomics. For L = 32, each warp sums its 32
//   values' dcb terms with a butterfly across the lanes that leaves
//   codeword `lane`'s sum in lane `lane` (31 shuffles for all 32
//   codewords), each lane keeps that one sum in a register across the
//   grid-stride loop, and the block sums its warps' rows in shared memory
//   in a fixed order into one partial row. (Other L: a shuffle tree per
//   value and codeword into the warps' rows.) The wrapper caps the grid
//   at kTrainBlocksPerSM blocks per SM, so there are few rows, and a second
//   kernel sums them, one warp per codeword, in a fixed order: a repeated
//   call on one card and grid gives the same bits.
// - K3 is K4's first kernel without the codebook pass: one templated body
//   (codebook_bwd_kernel, kTrain false for K3) takes the same one pass for
//   L = 32 and keeps no w~_j or dlw_j in registers.
// - The launch bounds cap K2 and K3 at 64 registers (4 blocks of 256 per SM)
//   and K4 at 128 (2 blocks): at L = 32 the unrolled passes would take ~120
//   and ~220.
//
// Numerics: build without --use_fast_math, so log1pf, expf and the divisions
// are the accurate ones wherever they are written so, and the argmax agrees
// with the plain PyTorch version except at near-ties. The constants
// -(v+1)/2, -(v+1) gamma and -2 gamma are formed in double and rounded to
// float once, as PyTorch rounds a Python scalar against a float32 tensor.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCodes = 256;
constexpr int kFastCodes = 32;    // the L compiled with unrolled loops
constexpr float kNegInf = -1e30f;
constexpr int kFwdBlocksPerSM = 4;    // K2 in at most 64 registers
constexpr int kBwdBlocksPerSM = 4;    // K3 in at most 64 registers
constexpr int kTrainBlocksPerSM = 2;  // K4 in at most 128 registers (TRAIN_BLOCKS_PER_SM)

// e^x to a few ulp (ex2.approx of x log2 e); a result below 2^-126 is 0
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.44269504088896341f));
  return y;
}

// Log kernel weight of x against codeword c and its derivative in x. The
// fast forms (logw_fast, logw_dlogw_fast) divide by v through its
// reciprocal: t / v = q0 + (t - q0 v) (1/v) with q0 = t (1/v), two FMAs
// that round to the IEEE quotient for t in [2^-64, 2^64] and 2^-10 <= v <=
// 2^10 (check_division.py compares them for every such float t at several
// v), so lw keeps its bits. The accurate forms (logw, logw_dlogw)
// serve every L other than 32 and the values outside that range.
template <bool kGauss>
struct Weights {
  float v;      // degrees of freedom (t-Student)
  float gamma;
  float coef;   // -(v + 1) / 2 (t-Student) or -gamma (Gaussian)
  float dcoef;  // -(v + 1) * gamma (t-Student) or -2 gamma (Gaussian)
  float rv;     // 1 / v, rounded
  float d_lo;   // the fast forms take x whose |x - c| are all in [d_lo, d_hi]
  float d_hi;

  __device__ __forceinline__ float logw(float x, float c) const {
    const float d = x - c;
    if (kGauss) return (coef * d) * d;
    const float gd = gamma * d;
    return coef * log1pf(gd * gd / v);
  }

  __device__ __forceinline__ void logw_dlogw(float x, float c, float& lw, float& dlw) const {
    const float d = x - c;
    if (kGauss) {
      lw = (coef * d) * d;
      dlw = dcoef * d;
      return;
    }
    const float gd = gamma * d;
    const float t = gd * gd;
    lw = coef * log1pf(t / v);
    dlw = dcoef * gd / (v + t);
  }

  __device__ __forceinline__ float div_v(float t) const {
    const float q0 = t * rv;
    return fmaf(fmaf(-q0, v, t), rv, q0);
  }

  __device__ __forceinline__ float logw_fast(float x, float c) const {
    const float d = x - c;
    if (kGauss) return (coef * d) * d;
    const float gd = gamma * d;
    return coef * log1pf(div_v(gd * gd));
  }

  __device__ __forceinline__ void logw_dlogw_fast(float x, float c, float& lw,
                                                  float& dlw) const {
    const float d = x - c;
    if (kGauss) {
      lw = (coef * d) * d;
      dlw = dcoef * d;
      return;
    }
    const float gd = gamma * d;
    const float t = gd * gd;
    lw = coef * log1pf(div_v(t));
    dlw = dcoef * gd / (v + t);
  }

  // the largest log-weight and the first codeword that reaches it
  __device__ __forceinline__ void argmax(float x, const float* cb, int L, float& m,
                                         int& best) const {
    m = kNegInf;
    best = 0;
    for (int j = 0; j < L; ++j) {
      const float lw = logw(x, cb[j]);
      if (lw > m) {
        m = lw;
        best = j;
      }
    }
  }

};

template <bool kGauss>
Weights<kGauss> make_weights(double v, double gamma) {
  Weights<kGauss> k;
  k.v = static_cast<float>(v);
  k.gamma = static_cast<float>(gamma);
  k.coef = static_cast<float>(kGauss ? -gamma : -(v + 1.0) / 2.0);
  k.dcoef = static_cast<float>(kGauss ? -2.0 * gamma : -(v + 1.0) * gamma);
  k.rv = 1.0f / k.v;
  k.d_lo = 0.f;  // the Gaussian weights divide by nothing
  k.d_hi = INFINITY;
  if (!kGauss) {
    // (gamma d)^2 in [2^-61, 2^61] where |d| in [2^-30, 2^30] / |gamma|;
    // outside the checked v, or for an extreme gamma, no value is fast
    const double g = std::fabs(static_cast<double>(k.gamma));
    const bool exact = k.v >= 0x1p-10f && k.v <= 0x1p10f && g >= 0x1p-20 && g <= 0x1p20;
    k.d_lo = exact ? static_cast<float>(0x1p-30 / g) : INFINITY;
    k.d_hi = exact ? static_cast<float>(0x1p30 / g) : 0.f;
  }
  return k;
}

__device__ __forceinline__ void load_codes(const float* __restrict__ src, float* dst, int L) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) dst[j] = src[j];
}

// The codeword nearest to x by the rounded |x - c| (the first on a tie),
// and that distance.
__device__ __forceinline__ float nearest_code(float x, const float* cb, float& dn) {
  float cn = cb[0];
  dn = fabsf(x - cn);
#pragma unroll
  for (int j = 1; j < kFastCodes; ++j) {
    const float c = cb[j];
    const float d = fabsf(x - c);
    if (d < dn) {
      dn = d;
      cn = c;
    }
  }
  return cn;
}

// One pass of a value over the codewords against a maximum m: the sums of
// w~_j = exp(lw_j - m), s and csum, with kBackward also a and b and, with
// kKeep (K4 at L = 32), w~_j and dlw_j in w[], dl[].
// kFast (L = 32; m is the nearest codeword's log-weight, a trial maximum):
// the fast forms of the log-weights and, for K2, whose soft value is held to
// an absolute tolerance, the weights' exp as ex2.approx (K3 and K4 keep the
// accurate expf: check_backward holds each dcb_j to its terms' own scale,
// which for a codeword far from every value lies in the subnormal range,
// where only the plain version's own arithmetic meets it). Returns whether
// m is the maximum, no lw_j being above it, and then `best` is the first j
// with lw_j == m. Otherwise (m is the maximum already) returns true.
template <bool kGauss, int kL, bool kBackward, bool kKeep, bool kFast>
__device__ __forceinline__ bool one_pass(const Weights<kGauss>& k, float x, const float* cb,
                                         int L, float m, float& s, float& a, float& b,
                                         float& csum, int& best, float* w, float* dl) {
  static_assert(!kFast || kL == kFastCodes, "the fast forms are compiled for L = 32");
  static_assert(!kKeep || (kBackward && kL > 0), "only K4 at a compiled L keeps w~ and dlw");
  const int n = kL > 0 ? kL : L;
  s = a = b = csum = 0.f;
  float mx = kNegInf;
  unsigned reach = 0u;  // kFast: bit j set where lw_j >= m
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float c = cb[j];
    float lw, dlw;
    if (kBackward) {
      if (kFast) k.logw_dlogw_fast(x, c, lw, dlw); else k.logw_dlogw(x, c, lw, dlw);
    } else {
      lw = kFast ? k.logw_fast(x, c) : k.logw(x, c);
    }
    if (kFast) {
      mx = fmaxf(mx, lw);
      if (lw >= m) reach |= 1u << j;
    }
    const float wt = kFast && !kBackward ? exp_approx(lw - m) : expf(lw - m);
    s += wt;
    if (kBackward) {
      a += wt * dlw;
      b += c * (wt * dlw);
      if (kKeep) {
        w[j] = wt;
        dl[j] = dlw;
      }
    }
    csum += c * wt;
  }
  if (!kFast) return true;
  best = __ffs(reach) - 1;
  return mx <= m && reach != 0u;
}

// The sums of one value and its hard index. For L = 32, one pass in the
// fast forms against the nearest codeword's log-weight, where that is exact
// (the fast forms in range, no log-weight above it and one equal to it);
// otherwise, and for any other L, the two-pass rule: the max and its first
// argmax, then the sums. cmin, cmax: the smallest and largest codeword.
template <bool kGauss, int kL, bool kBackward, bool kKeep>
__device__ __forceinline__ void value_pass(const Weights<kGauss>& k, float x, const float* cb,
                                           int L, float cmin, float cmax, float& m, float& s,
                                           float& a, float& b, float& csum, int& best, float* w,
                                           float* dl) {
  if constexpr (kL > 0) {
    float dn;
    const float cn = nearest_code(x, cb, dn);
    if (dn >= k.d_lo && fmaxf(fabsf(x - cmin), fabsf(x - cmax)) <= k.d_hi) {
      m = k.logw_fast(x, cn);
      if (m > kNegInf &&
          one_pass<kGauss, kL, kBackward, kKeep, true>(k, x, cb, L, m, s, a, b, csum, best, w,
                                                       dl)) {
        return;
      }
    }
  }
  k.argmax(x, cb, L, m, best);
  one_pass<kGauss, kL, kBackward, kKeep, false>(k, x, cb, L, m, s, a, b, csum, best, w, dl);
}

// The smallest and the largest of the L codewords in shared memory.
__device__ __forceinline__ void code_range(const float* cb, int L, float& cmin, float& cmax) {
  cmin = cmax = cb[0];
  for (int j = 1; j < L; ++j) {
    cmin = fminf(cmin, cb[j]);
    cmax = fmaxf(cmax, cb[j]);
  }
}

// K2: soft (N,) and hard index (N,) of z (N,) against cb (L,).
template <bool kGauss, int kL>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSM)
codebook_fwd_kernel(const float* __restrict__ z, const float* __restrict__ cb, int L,
                    long long n, Weights<kGauss> k, float* __restrict__ soft,
                    int* __restrict__ hard) {
  __shared__ float s_cb[kMaxCodes];
  load_codes(cb, s_cb, L);
  __syncthreads();
  float cmin, cmax;
  code_range(s_cb, L, cmin, cmax);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = z[i];
    float m, s, a, b, acc;
    int best;
    value_pass<kGauss, kL, false, false>(k, x, s_cb, L, cmin, cmax, m, s, a, b, acc, best,
                                         nullptr, nullptr);
    soft[i] = acc / s;
    hard[i] = best;
  }
}

// The 32 per-lane values v[0..31] of a warp summed across its lanes,
// codeword `lane`'s sum returned in lane `lane`: a butterfly that halves the
// vector at each of 5 steps (16 + 8 + 4 + 2 + 1 shuffles), in a fixed order.
// Each step is its own instantiation, so every index is a constant and v
// stays in registers.
template <int kHalf>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kFastCodes]) {
  const bool upper = threadIdx.x & kHalf;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
  if constexpr (kHalf > 1) {
    return warp_transpose_sum<kHalf / 2>(v);
  } else {
    return v[0];
  }
}

// K3 (kTrain false): dz (N,) from z, g (N,), cb and pc (L,), the entropy
// cotangent at each codeword. K4's first kernel (kTrain): the same dz, and
// one row of dcb partial sums per block in partial (gridDim.x, L). Whole
// warps step through the grid-stride loop together (K4's shuffles need every
// lane); lanes past N store and add nothing.
template <bool kGauss, int kL, bool kTrain>
__global__ void __launch_bounds__(kThreads, kTrain ? kTrainBlocksPerSM : kBwdBlocksPerSM)
codebook_bwd_kernel(const float* __restrict__ z, const float* __restrict__ g,
                    const float* __restrict__ cb, const float* __restrict__ pc, int L,
                    long long n, float inv_n, Weights<kGauss> k, float* __restrict__ dz,
                    float* __restrict__ partial) {
  static_assert(kL == 0 || kL == kFastCodes, "the compiled L is one warp of codewords");
  constexpr bool kKeep = kTrain && kL > 0;
  constexpr int kKept = kKeep ? kL : 1;
  __shared__ float s_cb[kMaxCodes];
  __shared__ float s_pc[kMaxCodes];
  __shared__ float s_acc[kTrain ? kWarps : 1][kMaxCodes];
  load_codes(cb, s_cb, L);
  load_codes(pc, s_pc, L);
  if (kTrain && kL == 0) {
    for (int j = threadIdx.x; j < kWarps * kMaxCodes; j += blockDim.x) (&s_acc[0][0])[j] = 0.f;
  }
  __syncthreads();
  float cmin = 0.f, cmax = 0.f;
  if (kL > 0) code_range(s_cb, L, cmin, cmax);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float dcb = 0.f;  // K4, kL > 0: this warp's sum for codeword `lane`
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    const float x = valid ? z[i] : s_cb[0];
    float m, s, a, b, csum, w[kKept], dl[kKept];
    int best;
    value_pass<kGauss, kL, true, kKeep>(k, x, s_cb, L, cmin, cmax, m, s, a, b, csum, best, w,
                                        dl);
    const float gn = (valid ? g[i] : 0.f) + s_pc[best] * inv_n;
    if (valid) dz[i] = gn * ((b - csum * (a / s)) / s);
    if constexpr (kTrain) {
      const float gm = valid ? gn : 0.f;
      const float soft = csum / s;
      if constexpr (kL > 0) {
        // this warp's values' shares of dcb_j from the w~_j and dlw_j they
        // kept, in the plain version's order (w~_j / s as w~_j (1/s)), summed
        // across the lanes
        const float r = 1.f / s;
#pragma unroll
        for (int j = 0; j < kL; ++j) w[j] = gm * (w[j] * r) * (1.f - dl[j] * (s_cb[j] - soft));
        dcb += warp_transpose_sum<16>(w);
      } else {
        // this warp's share of dcb_j, evaluated again and summed by a shuffle
        // tree
        for (int j = 0; j < L; ++j) {
          const float c = s_cb[j];
          float lw, dlw;
          k.logw_dlogw(x, c, lw, dlw);
          const float wj = expf(lw - m) / s;
          float t = gm * wj * (1.f - dlw * (c - soft));
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
          if (lane == 0) s_acc[warp][j] += t;
        }
      }
    }
  }
  if constexpr (kTrain) {
    if (kL > 0) s_acc[warp][lane] = dcb;
    __syncthreads();
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      float t = 0.f;
      for (int r = 0; r < kWarps; ++r) t += s_acc[r][j];
      partial[static_cast<size_t>(blockIdx.x) * L + j] = t;
    }
  }
}

// K4, second kernel: dcb_j = sum over rows r of partial[r][j], one warp per
// codeword: lane l sums rows l, l + 32, ... in order, then a shuffle tree.
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ partial, int rows, int L, float* __restrict__ out) {
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= L) return;  // whole warps leave together
  float t = 0.f;
  for (int r = lane; r < rows; r += 32) t += partial[static_cast<size_t>(r) * L + j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
  if (lane == 0) out[j] = t;
}

// K2, K3 and K4 compiled for L = 32, or for any L
template <bool kGauss>
void launch_fwd(const float* z, const float* cb, int L, long long n, double v, double gamma,
                int blocks, float* soft, int* hard, cudaStream_t stream) {
  const Weights<kGauss> k = make_weights<kGauss>(v, gamma);
  if (L == kFastCodes) {
    codebook_fwd_kernel<kGauss, kFastCodes><<<blocks, kThreads, 0, stream>>>(z, cb, L, n, k,
                                                                             soft, hard);
  } else {
    codebook_fwd_kernel<kGauss, 0><<<blocks, kThreads, 0, stream>>>(z, cb, L, n, k, soft, hard);
  }
}

// K3 (kTrain false; partial unused) or K4's first kernel
template <bool kGauss, bool kTrain>
void launch_bwd(const float* z, const float* g, const float* cb, const float* pc, int L,
                long long n, float inv_n, double v, double gamma, int blocks, float* dz,
                float* partial, cudaStream_t stream) {
  const Weights<kGauss> k = make_weights<kGauss>(v, gamma);
  if (L == kFastCodes) {
    codebook_bwd_kernel<kGauss, kFastCodes, kTrain><<<blocks, kThreads, 0, stream>>>(
        z, g, cb, pc, L, n, inv_n, k, dz, partial);
  } else {
    codebook_bwd_kernel<kGauss, 0, kTrain><<<blocks, kThreads, 0, stream>>>(
        z, g, cb, pc, L, n, inv_n, k, dz, partial);
  }
}

}  // namespace

// Every function below takes float32 contiguous arrays on CUDA device
// `device`: z, g, soft, dz (N,), hard (N,) int32, cb, pc, dcb (L,), and
// partial (blocks, L). The caller checks 1 <= L <= 256, N >= 1 and
// 1 <= blocks <= 65535, launches with `blocks` blocks of 256 threads, and
// picks v <= 0 for the Gaussian kernel. The library links its own CUDA
// runtime, whose current device is set here. Each returns the first CUDA
// error of its launches (0 = cudaSuccess).
extern "C" int codebook_fwd(const float* z, const float* cb, int L, long long n, double v,
                            double gamma, int blocks, float* soft, int* hard, int device,
                            cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (v <= 0) {
    launch_fwd<true>(z, cb, L, n, v, gamma, blocks, soft, hard, stream);
  } else {
    launch_fwd<false>(z, cb, L, n, v, gamma, blocks, soft, hard, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int codebook_bwd(const float* z, const float* g, const float* cb, const float* pc,
                            int L, long long n, double v, double gamma, int blocks, float* dz,
                            int device, cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const float inv_n = static_cast<float>(1.0 / static_cast<double>(n));
  if (v <= 0) {
    launch_bwd<true, false>(z, g, cb, pc, L, n, inv_n, v, gamma, blocks, dz, nullptr, stream);
  } else {
    launch_bwd<false, false>(z, g, cb, pc, L, n, inv_n, v, gamma, blocks, dz, nullptr, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int codebook_bwd_train(const float* z, const float* g, const float* cb,
                                  const float* pc, int L, long long n, double v, double gamma,
                                  int blocks, float* dz, float* partial, float* dcb,
                                  int device, cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const float inv_n = static_cast<float>(1.0 / static_cast<double>(n));
  if (v <= 0) {
    launch_bwd<true, true>(z, g, cb, pc, L, n, inv_n, v, gamma, blocks, dz, partial, stream);
  } else {
    launch_bwd<false, true>(z, g, cb, pc, L, n, inv_n, v, gamma, blocks, dz, partial, stream);
  }
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  sum_rows_kernel<<<(L + kWarps - 1) / kWarps, kThreads, 0, stream>>>(partial, blocks, L, dcb);
  return static_cast<int>(cudaGetLastError());
}
