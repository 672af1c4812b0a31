// Fused soft-codebook quantizer (K2) and its two backwards (K3: fixed
// codebook, K4: trainable codebook) for Hopper (sm_90a).
//
// For every latent value x and every codeword c_j of an L-entry codebook
// (L <= 256), the log kernel weight is
//     t-Student (v > 0):  lw_j = -(v + 1)/2 * log1p((gamma (x - c_j))^2 / v)
//     Gaussian (v <= 0):  lw_j = -gamma (x - c_j)^2
// and w_j = softmax_j(lw). Each kernel makes its passes over the codewords
// per value, so the (N, L) weight matrix never exists in memory:
//   K2 (codebook_fwd)   pass 1: max and first argmax of lw (strict >, the
//                       first codeword wins a tie); pass 2: soft = sum w c.
//   K3 (codebook_bwd)   K2's passes with four running sums s = sum w~,
//                       A = sum w~ dlw, B = sum c w~ dlw, C = sum c w~ (w~ =
//                       exp(lw - max)); dz = (g + pc[argmax]/N) (B - C A/s)/s.
//   K4 (codebook_bwd_train) K3's dz and a third pass for the codebook
//                       cotangent dcb_j = sum_n gn w_nj (1 - dlw_nj (c_j - soft_n)).
//
// Replaces the TPU kernels of neural_imaging_tpu/ops/pallas/codebook.py:
// _kernel (K2), _bwd_kernel (K3) and _bwd_train_kernel (K4). Those stream
// (8, 128) tiles through VMEM over a sequential grid, read the codebook from
// SMEM, pad N up to whole tiles with cb[0], and K4 carries dcb in a (1, L)
// output that the sequential grid revisits. Here one thread takes one value
// (grid-stride loop), the codebook sits in shared memory, the ragged edge is
// masked instead of padded, and K4 reduces dcb deterministically: a warp
// shuffle tree per codeword, per-warp rows in shared memory summed in a fixed
// order into one (blocks, L) partial row per block, and a second kernel that
// sums those rows in a fixed order. No atomics, so dcb is the same from run
// to run on one card and grid.
//
// Bound: operations. Each function needs, per value and codeword, one
// log1pf, one expf and one or two IEEE divisions (24, 7 and 10 SASS
// instructions on sm_90a, as sass_costs.py counts them), against 12 bytes of
// memory traffic per value: at L = 32 some 1,600 instructions for 12 bytes,
// far above the H100's ~10 instructions/byte ridge (chip_smoke.py states the
// count). This design does more than that: it evaluates each log-weight again
// in every pass (twice in K2 and K3, three times in K4) instead of keeping the
// L log-weights in registers, and K4 runs a shuffle tree per value and
// codeword. It reads each input and writes each output once, coalesced.
//
// Numerics: build without --use_fast_math, so log1pf, expf and the divisions
// are the accurate ones and the argmax agrees with the plain PyTorch version
// except at near-ties. The constants -(v+1)/2, -(v+1) gamma and -2 gamma are
// formed in double and rounded to float once, as PyTorch rounds a Python
// scalar against a float32 tensor.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCodes = 256;

// Log kernel weight of x against codeword c and its derivative in x.
template <bool kGauss>
struct Weights {
  float v;      // degrees of freedom (t-Student)
  float gamma;
  float coef;   // -(v + 1) / 2 (t-Student) or -gamma (Gaussian)
  float dcoef;  // -(v + 1) * gamma (t-Student) or -2 gamma (Gaussian)

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

  // pass 1: the largest log-weight and the first codeword that reaches it
  __device__ __forceinline__ void argmax(float x, const float* cb, int L, float& m,
                                         int& best) const {
    m = -1e30f;
    best = 0;
    for (int j = 0; j < L; ++j) {
      const float lw = logw(x, cb[j]);
      if (lw > m) {
        m = lw;
        best = j;
      }
    }
  }

  // pass 2 of the backwards: s = sum w~, a = sum w~ dlw, b = sum c w~ dlw,
  // csum = sum c w~, with w~ = exp(lw - m)
  __device__ __forceinline__ void sums(float x, const float* cb, int L, float m, float& s,
                                       float& a, float& b, float& csum) const {
    s = a = b = csum = 0.f;
    for (int j = 0; j < L; ++j) {
      const float c = cb[j];
      float lw, dlw;
      logw_dlogw(x, c, lw, dlw);
      const float w = expf(lw - m);
      s += w;
      a += w * dlw;
      b += c * (w * dlw);
      csum += c * w;
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
  return k;
}

__device__ __forceinline__ void load_codes(const float* __restrict__ src, float* dst, int L) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) dst[j] = src[j];
}

// K2: soft (N,) and hard index (N,) of z (N,) against cb (L,).
template <bool kGauss>
__global__ void __launch_bounds__(kThreads)
codebook_fwd_kernel(const float* __restrict__ z, const float* __restrict__ cb, int L,
                    long long n, Weights<kGauss> k, float* __restrict__ soft,
                    int* __restrict__ hard) {
  __shared__ float s_cb[kMaxCodes];
  load_codes(cb, s_cb, L);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = z[i];
    float m;
    int best;
    k.argmax(x, s_cb, L, m, best);
    float s = 0.f, acc = 0.f;
    for (int j = 0; j < L; ++j) {
      const float c = s_cb[j];
      const float w = expf(k.logw(x, c) - m);
      s += w;
      acc += w * c;
    }
    soft[i] = acc / s;
    hard[i] = best;
  }
}

// K3: dz (N,) from z, g (N,), cb and pc (L,), the entropy cotangent at each
// codeword.
template <bool kGauss>
__global__ void __launch_bounds__(kThreads)
codebook_bwd_kernel(const float* __restrict__ z, const float* __restrict__ g,
                    const float* __restrict__ cb, const float* __restrict__ pc, int L,
                    long long n, float inv_n, Weights<kGauss> k, float* __restrict__ dz) {
  __shared__ float s_cb[kMaxCodes];
  __shared__ float s_pc[kMaxCodes];
  load_codes(cb, s_cb, L);
  load_codes(pc, s_pc, L);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = z[i];
    float m;
    int best;
    k.argmax(x, s_cb, L, m, best);
    float s, a, b, csum;
    k.sums(x, s_cb, L, m, s, a, b, csum);
    dz[i] = (g[i] + s_pc[best] * inv_n) * ((b - csum * (a / s)) / s);
  }
}

// K4, first kernel: K3's dz, and one row of dcb partial sums per block in
// partial (gridDim.x, L). Whole warps step through the grid-stride loop
// together (the shuffles need every lane); lanes past N add nothing.
template <bool kGauss>
__global__ void __launch_bounds__(kThreads)
codebook_bwd_train_kernel(const float* __restrict__ z, const float* __restrict__ g,
                          const float* __restrict__ cb, const float* __restrict__ pc,
                          int L, long long n, float inv_n, Weights<kGauss> k,
                          float* __restrict__ dz, float* __restrict__ partial) {
  __shared__ float s_cb[kMaxCodes];
  __shared__ float s_pc[kMaxCodes];
  __shared__ float s_acc[kWarps][kMaxCodes];
  load_codes(cb, s_cb, L);
  load_codes(pc, s_pc, L);
  for (int j = threadIdx.x; j < kWarps * kMaxCodes; j += blockDim.x) (&s_acc[0][0])[j] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    const float x = valid ? z[i] : s_cb[0];
    float m;
    int best;
    k.argmax(x, s_cb, L, m, best);
    float s, a, b, csum;
    k.sums(x, s_cb, L, m, s, a, b, csum);
    const float soft = csum / s;
    const float gn = (valid ? g[i] : 0.f) + s_pc[best] * inv_n;
    if (valid) dz[i] = gn * ((b - csum * (a / s)) / s);
    const float gm = valid ? gn : 0.f;

    // pass 3: this warp's share of dcb_j, summed by a shuffle tree
    for (int j = 0; j < L; ++j) {
      const float c = s_cb[j];
      float lw, dlw;
      k.logw_dlogw(x, c, lw, dlw);
      const float w = expf(lw - m) / s;
      float t = gm * w * (1.f - dlw * (c - soft));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
      if (lane == 0) s_acc[warp][j] += t;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s_acc[w][j];
    partial[static_cast<size_t>(blockIdx.x) * L + j] = t;
  }
}

// K4, second kernel: dcb_j = sum over rows r of partial[r][j], in row order.
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ partial, int rows, int L, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  float t = 0.f;
  for (int r = 0; r < rows; ++r) t += partial[static_cast<size_t>(r) * L + j];
  out[j] = t;
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
    codebook_fwd_kernel<true><<<blocks, kThreads, 0, stream>>>(
        z, cb, L, n, make_weights<true>(v, gamma), soft, hard);
  } else {
    codebook_fwd_kernel<false><<<blocks, kThreads, 0, stream>>>(
        z, cb, L, n, make_weights<false>(v, gamma), soft, hard);
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
    codebook_bwd_kernel<true><<<blocks, kThreads, 0, stream>>>(
        z, g, cb, pc, L, n, inv_n, make_weights<true>(v, gamma), dz);
  } else {
    codebook_bwd_kernel<false><<<blocks, kThreads, 0, stream>>>(
        z, g, cb, pc, L, n, inv_n, make_weights<false>(v, gamma), dz);
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
    codebook_bwd_train_kernel<true><<<blocks, kThreads, 0, stream>>>(
        z, g, cb, pc, L, n, inv_n, make_weights<true>(v, gamma), dz, partial);
  } else {
    codebook_bwd_train_kernel<false><<<blocks, kThreads, 0, stream>>>(
        z, g, cb, pc, L, n, inv_n, make_weights<false>(v, gamma), dz, partial);
  }
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  sum_rows_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, blocks, L,
                                                                         dcb);
  return static_cast<int>(cudaGetLastError());
}
