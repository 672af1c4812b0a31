// K5: the FAN's conv stages for Hopper (sm_90a), float32 on the CUDA cores.
//
//   forward  y = max_pool2x2(leaky_relu(conv5x5_SAME(x, W) + b, 0.2)) and a
//            uint8 code a pooled output: bits 0-1 the window position that
//            won (row-major: 0 top left, 3 bottom right), bit 2 whether that
//            position's pre-activation was >= 0;
//   dgrad    dx from the pooled gradient and the code: the code expands the
//            gradient to full resolution in shared memory (the winner's
//            value, times the leaky slope where bit 2 is clear, and 0 at the
//            window's 3 other positions), which is correlated with the
//            flipped, transposed weights;
//   wgrad    dW and db from the pooled gradient, the code and the stage's
//            input, gathered at the winning positions only: the other three
//            quarters of the full-resolution gradient are exact zeros, so the
//            sums are the dense ones with a quarter of the products.
// The full-resolution activation and its gradient never reach device memory.
//
// Replaces no TPU kernel: the JAX package leaves the FAN's convolutions to
// XLA. They were the port's largest layer, on cuDNN's float32 engines with
// TF32 off, with each stage's activation and pool as separate full-resolution
// passes.
//
// Bound: at the FAN's widths the stages do 13-52 FLOP per byte they must
// move, above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP/B),
// so they are bound by the FFMA rate of the CUDA cores; TF32 would change the
// numbers, so no tensor core is used. Design:
// - implicit GEMM, direct: a block computes a tile of output channels over a
//   tile of pixels of one image, aligned to the 2x2 windows; a thread holds
//   2 rows x 4 columns of pixels (two whole windows) for 4 or 8 channels;
// - each reduction chunk (CK input channels) is staged in shared memory, its
//   input tile with a 2-pixel halo and its weights (laid out tap by tap by a
//   small kernel first), by cp.async into a ring of two stages: the next
//   chunk is in flight while this one is summed;
// - per (channel, kernel row) a thread reads its 2 input rows once (8 values
//   each, two 16-byte loads) and slides the 5 taps over them in registers;
//   each tap's weights are one or two 16-byte loads that the warp's threads
//   share. 64 FFMAs a tap and thread against 2 loads;
// - the epilogue adds the bias, applies the slope, takes each window's max
//   in registers and writes the pooled value and its code;
// - the dgrad is the same loop over the expanded gradient, dense: it sums the
//   window's 3 zeros too (a gathered dgrad, a 5x5 stamp a winner, was slower:
//   a stamp that lands on a thread's tile holds too few products for the
//   branch that places it);
// - the wgrad gives each lane of a warp one input channel and each warp 4
//   output channels, so a window's winner is the same for the whole warp and
//   its 4-way choice is a branch that never diverges: a lane loads the 6x6
//   input patch of a pooled position once and makes the 25 taps of each of
//   its 4 channels from registers. The stem's 3 channels take a lane per tap
//   instead, which loads each product's input at its offset from the winner.
//   Blocks split the N (H/2) (W/2) positions and leave partial sums, which a
//   second kernel adds in double in a fixed order: no float atomics, the
//   same bits every run.
//
// Numerics: IEEE float32 FMAs (built without --use_fast_math), sums in a
// fixed order: per output over input channels ascending, then the kernel's
// rows and columns; the dgrad, and the forward past 64 channels, sum each
// stage's products apart and then add the stages' sums, which keeps their
// rounding within twice cuDNN's (tests/test_torch_gpu.py). The max and its
// position follow F.max_pool2d: the first maximum in row-major order wins a
// tie, and a NaN wins (the last NaN of the window). The slope is 0.2f,
// applied as F.leaky_relu applies it (v > 0 ? v : v * 0.2f); the derivative
// at 0 is 1, jax's.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr float kSlope = 0.2f;
constexpr int kForwardChain = 16;   // stages the forward sums in one chain at most

// -- copies -------------------------------------------------------------------------

// 8 or 16 bytes from device to shared memory, zero-filled where !valid (src must
// still be a valid address); completes at the next wait_copies.
__device__ __forceinline__ void copy8(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
#else
  dst[0] = valid ? src[0] : 0.f;
  dst[1] = valid ? src[1] : 0.f;
#endif
}

__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = valid ? src[i] : 0.f;
#endif
}

__device__ __forceinline__ void commit_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// the full-resolution gradient at a window's 4 positions: g' at the winner
// (g, or g * slope where the pre-activation was negative), 0 elsewhere
__device__ __forceinline__ float winner_gradient(float g, unsigned code) {
  return (code & 4u) ? g : g * kSlope;
}

// -- the conv stage: forward and dgrad --------------------------------------------

// A launch's tile. CK reduction channels a stage of the ring; BCO output
// channels and BR x BC pixels a block; TCO channels and 2 x 4 pixels a
// thread. A thread's channels are (h * CG + cg) * 4 + j, h < TCO / 4, j < 4, so
// the warp's 16-byte weight loads cover consecutive banks. PITCH: floats
// between the rows of the input tile, chosen so that a warp's input loads
// fall in distinct banks.
template <int CK_, int BCO_, int TCO_, int BR_, int BC_, int PITCH_, int MIN_BLOCKS_,
          bool UNROLL_ROWS_ = false>
struct ConvTile {
  static constexpr int CK = CK_, BCO = BCO_, TCO = TCO_, BR = BR_, BC = BC_;
  static constexpr int PITCH = PITCH_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool UNROLL_ROWS = UNROLL_ROWS_;   // the kernel-row loop unrolled
  static constexpr int CG = BCO / TCO;    // channel groups
  static constexpr int PGC = BC / 4;      // pixel groups (2 x 4 pixels) a row
  static constexpr int PGR = BR / 2;
  static constexpr int HR = BR + 4, HC = BC + 4;   // the input tile with its halo
  static constexpr int IN_FLOATS = CK * HR * PITCH;
  static constexpr int W_FLOATS = CK * 25 * BCO;
  static constexpr int STAGE = IN_FLOATS + W_FLOATS;
  static constexpr int BYTES = 2 * STAGE * 4;
  // dgrad: pooled gradient values a stage and a thread
  static constexpr int POOLED = CK * (HR / 2) * (HC / 2);
  static constexpr int POOLED_PER_THREAD = (POOLED + kThreads - 1) / kThreads;
  static_assert(CG * PGC * PGR == kThreads, "a tile is 128 threads");
  static_assert(TCO == 4 || TCO == 8, "4 or 8 channels a thread");
  static_assert(PITCH >= HC && PITCH % 4 == 0, "16-byte aligned rows");
  static_assert(IN_FLOATS % 4 == 0 && STAGE % 4 == 0, "16-byte aligned stages");
};

// the stem (3 input channels): one chunk of 3, 32 output channels
using StemTile = ConvTile<3, 32, 8, 16, 16, 24, 3>;
// 64 output channels a block; 32 (the dgrad of conv1), its kernel rows unrolled
using Wide64Tile = ConvTile<4, 64, 8, 8, 16, 20, 3>;
using Wide32Tile = ConvTile<4, 32, 8, 16, 16, 24, 3, true>;
// the stem's dgrad: 3 output channels, padded to 4
using Narrow4Tile = ConvTile<4, 4, 4, 16, 64, 68, 3>;

struct ConvArgs {
  const float* in;              // forward: x (n, c_red, h, w); dgrad: dy (n, c_red, h/2, w/2)
  const unsigned char* code;    // dgrad: (n, c_red, h/2, w/2)
  const float* wt;              // (c_red, 25, c_out_pad): the taps' weights, output channel last
  const float* bias;            // forward: (c_out)
  float* out;                   // forward: y (n, c_out, h/2, w/2); dgrad: dx (n, c_out, h, w)
  unsigned char* out_code;      // forward: (n, c_out, h/2, w/2)
  int c_red, c_out, c_out_pad, h, w;
  int tiles_x, tiles_y, co_tiles, chunks;
};

// the weights of chunk channels [c0, c0 + CK) and block channels [co0, co0 + BCO)
template <class T>
__device__ __forceinline__ void stage_weights(float* ws, const ConvArgs& a, int c0, int co0,
                                              int tid) {
  constexpr int QUADS = T::BCO / 4;
  constexpr int TOTAL = T::CK * 25 * QUADS;
  for (int e = tid; e < TOTAL; e += kThreads) {
    const int ck = e / (25 * QUADS), rem = e % (25 * QUADS);
    const int tap = rem / QUADS, q = rem % QUADS;
    const int c = c0 + ck;
    const bool valid = c < a.c_red;
    const float* src =
        valid ? a.wt + (static_cast<size_t>(c) * 25 + tap) * a.c_out_pad + co0 + 4 * q : a.wt;
    copy16(ws + (ck * 25 + tap) * T::BCO + 4 * q, src, valid);
  }
}

// forward: the input tile of chunk channels [c0, c0 + CK), rows y0 - 2 ..
// y0 + BR + 1 and columns x0 - 2 .. x0 + BC + 1, zeros outside the image
template <class T>
__device__ __forceinline__ void stage_input(float* xs, const ConvArgs& a, int n, int c0, int y0,
                                            int x0, int tid) {
  constexpr int PAIRS = T::HC / 2;
  constexpr int TOTAL = T::CK * T::HR * PAIRS;
  for (int e = tid; e < TOTAL; e += kThreads) {
    const int ck = e / (T::HR * PAIRS), rem = e % (T::HR * PAIRS);
    const int r = rem / PAIRS, p = rem % PAIRS;
    const int c = c0 + ck, y = y0 - 2 + r, x = x0 - 2 + 2 * p;
    const bool valid = c < a.c_red && y >= 0 && y < a.h && x >= 0 && x < a.w;
    const float* src =
        valid ? a.in + ((static_cast<size_t>(n) * a.c_red + c) * a.h + y) * a.w + x : a.in;
    copy8(xs + (ck * T::HR + r) * T::PITCH + 2 * p, src, valid);
  }
}

// dgrad: the pooled gradient and codes of the input tile's windows, in registers
template <class T>
struct PooledStage {
  float g[T::POOLED_PER_THREAD];
  unsigned code[T::POOLED_PER_THREAD];
};

template <class T>
__device__ __forceinline__ void fetch_pooled(PooledStage<T>& s, const ConvArgs& a, int n, int c0,
                                             int y0, int x0, int tid) {
  constexpr int PR = T::HR / 2, PC = T::HC / 2;
  const int hp = a.h / 2, wp = a.w / 2;
#pragma unroll
  for (int i = 0; i < T::POOLED_PER_THREAD; ++i) {
    const int e = tid + i * kThreads;
    const int ck = e / (PR * PC), rem = e % (PR * PC);
    const int c = c0 + ck, py = y0 / 2 - 1 + rem / PC, px = x0 / 2 - 1 + rem % PC;
    const bool valid =
        e < T::POOLED && c < a.c_red && py >= 0 && py < hp && px >= 0 && px < wp;
    const size_t at = ((static_cast<size_t>(n) * a.c_red + c) * hp + py) * wp + px;
    s.g[i] = valid ? a.in[at] : 0.f;
    s.code[i] = valid ? a.code[at] : 0u;
  }
}

// dgrad: the full-resolution gradient tile from the fetched windows
template <class T>
__device__ __forceinline__ void expand_pooled(float* xs, const PooledStage<T>& s, int tid) {
  constexpr int PR = T::HR / 2, PC = T::HC / 2;
#pragma unroll
  for (int i = 0; i < T::POOLED_PER_THREAD; ++i) {
    const int e = tid + i * kThreads;
    if (e >= T::POOLED) break;
    const int ck = e / (PR * PC), rem = e % (PR * PC);
    const int pr = rem / PC, pc = rem % PC;
    const unsigned code = s.code[i], at = code & 3u;
    const float v = winner_gradient(s.g[i], code);
    float* row = xs + (ck * T::HR + 2 * pr) * T::PITCH + 2 * pc;
    *reinterpret_cast<float2*>(row) = make_float2(at == 0u ? v : 0.f, at == 1u ? v : 0.f);
    *reinterpret_cast<float2*>(row + T::PITCH) =
        make_float2(at == 2u ? v : 0.f, at == 3u ? v : 0.f);
  }
}

// one stage's products: for each of its channels and kernel rows, the
// thread's 2 input rows of 8 values, slid over the 5 taps
template <class T>
__device__ __forceinline__ void accumulate(float (&acc)[2][4][T::TCO], const float* xs,
                                           const float* ws, int prow, int pcol, int cg) {
  const float* xp = xs + 2 * prow * T::PITCH + 4 * pcol;
  const float* wp = ws + 4 * cg;
#pragma unroll 1
  for (int ck = 0; ck < T::CK; ++ck) {
#pragma unroll(T::UNROLL_ROWS ? 5 : 1)
    for (int ky = 0; ky < 5; ++ky) {
      float in[2][8];
#pragma unroll
      for (int tr = 0; tr < 2; ++tr) {
        const float* row = xp + (ck * T::HR + ky + tr) * T::PITCH;
        const float4 lo = *reinterpret_cast<const float4*>(row);
        const float4 hi = *reinterpret_cast<const float4*>(row + 4);
        in[tr][0] = lo.x; in[tr][1] = lo.y; in[tr][2] = lo.z; in[tr][3] = lo.w;
        in[tr][4] = hi.x; in[tr][5] = hi.y; in[tr][6] = hi.z; in[tr][7] = hi.w;
      }
      const float* wrow = wp + (ck * 25 + ky * 5) * T::BCO;
#pragma unroll
      for (int kx = 0; kx < 5; ++kx) {
        float wv[T::TCO];
#pragma unroll
        for (int h = 0; h < T::TCO / 4; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(wrow + kx * T::BCO + h * T::CG * 4);
          wv[4 * h] = q.x; wv[4 * h + 1] = q.y; wv[4 * h + 2] = q.z; wv[4 * h + 3] = q.w;
        }
#pragma unroll
        for (int tr = 0; tr < 2; ++tr)
#pragma unroll
          for (int tc = 0; tc < 4; ++tc)
#pragma unroll
            for (int j = 0; j < T::TCO; ++j)
              acc[tr][tc][j] = fmaf(in[tr][tc + kx], wv[j], acc[tr][tc][j]);
      }
    }
  }
}

// kChunkSums: each stage's products summed apart before they are added (for
// long reductions: see below)
template <class T, bool kDgrad, bool kChunkSums>
__global__ void __launch_bounds__(kThreads, T::MIN_BLOCKS) fan_conv_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int cg = tid % T::CG, pg = tid / T::CG;
  const int prow = pg / T::PGC, pcol = pg % T::PGC;
  // blocks that share an input tile are neighbours: output-channel tiles vary fastest
  int b = blockIdx.x;
  const int co_tile = b % a.co_tiles;
  b /= a.co_tiles;
  const int tx = b % a.tiles_x;
  b /= a.tiles_x;
  const int ty = b % a.tiles_y;
  const int n = b / a.tiles_y;
  const int y0 = ty * T::BR, x0 = tx * T::BC, co0 = co_tile * T::BCO;

  PooledStage<T> pooled;
  stage_weights<T>(smem + T::IN_FLOATS, a, 0, co0, tid);
  if (!kDgrad) stage_input<T>(smem, a, n, 0, y0, x0, tid);
  commit_copies();
  if (kDgrad) {
    fetch_pooled<T>(pooled, a, n, 0, y0, x0, tid);
    expand_pooled<T>(smem, pooled, tid);
  }

  // acc sums a stage's products. With kChunkSums the stages' sums are added
  // in `total`, which keeps the rounding of a long reduction (3,200 products
  // at conv3) near a short one's. `total` lives in local memory (the empty asm
  // hides its address from the compiler): it is touched once a stage, and the
  // stages' loop keeps its registers for running ahead.
  float acc[2][4][T::TCO];
#pragma unroll
  for (int tr = 0; tr < 2; ++tr)
#pragma unroll
    for (int tc = 0; tc < 4; ++tc)
#pragma unroll
      for (int j = 0; j < T::TCO; ++j) acc[tr][tc][j] = 0.f;
  float total_store[kChunkSums ? 8 * T::TCO : 1];
  float* total = total_store;
#ifdef __CUDA_ARCH__
  asm volatile("" : "+l"(total));
#endif
  if (kChunkSums)
    for (int i = 0; i < 8 * T::TCO; ++i) total[i] = 0.f;

  for (int k = 0; k < a.chunks; ++k) {
    float* const stage = smem + (k & 1) * T::STAGE;
    float* const next = smem + ((k + 1) & 1) * T::STAGE;
    wait_copies();
    __syncthreads();   // stage k is in; every thread is done with stage k - 1's buffer
    const bool more = k + 1 < a.chunks;
    if (more) {
      const int c0 = (k + 1) * T::CK;
      stage_weights<T>(next + T::IN_FLOATS, a, c0, co0, tid);
      if (!kDgrad) stage_input<T>(next, a, n, c0, y0, x0, tid);
      commit_copies();
      if (kDgrad) fetch_pooled<T>(pooled, a, n, c0, y0, x0, tid);
    }
    accumulate<T>(acc, stage, stage + T::IN_FLOATS, prow, pcol, cg);
    if constexpr (kChunkSums) {
#pragma unroll
      for (int tr = 0; tr < 2; ++tr)
#pragma unroll
        for (int tc = 0; tc < 4; ++tc)
#pragma unroll
          for (int j = 0; j < T::TCO; ++j) {
            total[(tr * 4 + tc) * T::TCO + j] += acc[tr][tc][j];
            acc[tr][tc][j] = 0.f;
          }
    }
    if (kDgrad && more) expand_pooled<T>(next, pooled, tid);
  }
  if constexpr (kChunkSums) {
#pragma unroll
    for (int tr = 0; tr < 2; ++tr)
#pragma unroll
      for (int tc = 0; tc < 4; ++tc)
#pragma unroll
        for (int j = 0; j < T::TCO; ++j) acc[tr][tc][j] = total[(tr * 4 + tc) * T::TCO + j];
  }

  if (kDgrad) {
#pragma unroll
    for (int h = 0; h < T::TCO / 4; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + (h * T::CG + cg) * 4 + j;
        if (co >= a.c_out) continue;
#pragma unroll
        for (int tr = 0; tr < 2; ++tr) {
          const int y = y0 + 2 * prow + tr;
#pragma unroll
          for (int tc = 0; tc < 4; ++tc) {
            const int x = x0 + 4 * pcol + tc;
            if (y < a.h && x < a.w)
              a.out[((static_cast<size_t>(n) * a.c_out + co) * a.h + y) * a.w + x] =
                  acc[tr][tc][4 * h + j];
          }
        }
      }
  } else {
    const int hp = a.h / 2, wp = a.w / 2;
    const int py = y0 / 2 + prow;
#pragma unroll
    for (int h = 0; h < T::TCO / 4; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + (h * T::CG + cg) * 4 + j;
        if (co >= a.c_out) continue;
        const float bias = a.bias[co];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int px = x0 / 2 + 2 * pcol + q;
          if (py >= hp || px >= wp) continue;
          const float v[4] = {acc[0][2 * q][4 * h + j] + bias, acc[0][2 * q + 1][4 * h + j] + bias,
                              acc[1][2 * q][4 * h + j] + bias,
                              acc[1][2 * q + 1][4 * h + j] + bias};
          float best = -INFINITY, best_v = v[0];
          unsigned at = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float act = v[i] > 0.f ? v[i] : v[i] * kSlope;
            if (act > best || act != act) {
              best = act;
              best_v = v[i];
              at = i;
            }
          }
          const size_t o = ((static_cast<size_t>(n) * a.c_out + co) * hp + py) * wp + px;
          a.out[o] = best;
          a.out_code[o] = static_cast<unsigned char>(at | (best_v >= 0.f ? 4u : 0u));
        }
      }
  }
}

// -- the weight gradient ----------------------------------------------------------

// A block: CI_T input channels and 4 warps of 4 output channels, over items of
// PTR x PTC pooled positions (an image's tile), whose input tile (with its
// 2-pixel halo, HR x HC) it stages with rows PITCH and channels CSTRIDE floats
// apart, and the g' and window index of each (position, channel).
template <int CI_T_, int PTR_, int PTC_, int PITCH_, int CSTRIDE_, int MIN_BLOCKS_>
struct WgradTile {
  static constexpr int CI_T = CI_T_, CO_T = 4, PTR = PTR_, PTC = PTC_;
  static constexpr int PITCH = PITCH_, CSTRIDE = CSTRIDE_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WARPS = kThreads / 32;
  static constexpr int CO_BLK = WARPS * CO_T;
  static constexpr int HR = 2 * PTR + 4, HC = 2 * PTC + 4;
  static constexpr int Q = PTR * PTC;
  static constexpr int X_FLOATS = (CI_T * CSTRIDE + 3) / 4 * 4;
  static constexpr int G_FLOATS = CO_BLK * Q;
  static constexpr int STAGE = X_FLOATS + 2 * G_FLOATS;   // input tile, g', window index
  static constexpr int BYTES = 2 * STAGE * 4;
  static constexpr int G_PER_THREAD = (G_FLOATS + kThreads - 1) / kThreads;
  static_assert(PITCH >= HC && PITCH % 2 == 0 && CSTRIDE >= HR * PITCH && CSTRIDE % 2 == 0,
                "8-byte aligned rows");
};

// a lane per input channel: channels 242 floats apart (an odd half), so that 32
// channels' 8-byte loads fall in distinct bank pairs
using WgradWide = WgradTile<32, 4, 8, 20, 242, 3>;
// the stem's 3 channels: a lane per tap, rows 26 floats apart, so that the 25
// taps' offsets fall in distinct banks
using WgradStem = WgradTile<3, 4, 8, 26, 12 * 26, 6>;

struct WgradArgs {
  const float* dy;              // (n, c_out, h/2, w/2)
  const unsigned char* code;    // (n, c_out, h/2, w/2)
  const float* x;               // (n, c_in, h, w)
  float* partial;               // (splits, c_out * c_in * 25 + c_out)
  int n, c_in, c_out, h, w;
  int tiles_x, tiles_y, ci_tiles, co_tiles, splits;
};

template <class T>
struct GradStage {
  float g[T::G_PER_THREAD];
  unsigned code[T::G_PER_THREAD];
};

template <class T>
__device__ __forceinline__ void locate(const WgradArgs& a, int item, int& n, int& ty, int& tx) {
  tx = item % a.tiles_x;
  item /= a.tiles_x;
  ty = item % a.tiles_y;
  n = item / a.tiles_y;
}

template <class T>
__device__ __forceinline__ void stage_patch(float* xs, const WgradArgs& a, int item, int ci0,
                                            int tid) {
  int n, ty, tx;
  locate<T>(a, item, n, ty, tx);
  const int y0 = 2 * ty * T::PTR - 2, x0 = 2 * tx * T::PTC - 2;
  constexpr int PAIRS = T::HC / 2;
  constexpr int TOTAL = T::CI_T * T::HR * PAIRS;
  for (int e = tid; e < TOTAL; e += kThreads) {
    const int cl = e / (T::HR * PAIRS), rem = e % (T::HR * PAIRS);
    const int r = rem / PAIRS, p = rem % PAIRS;
    const int c = ci0 + cl, y = y0 + r, x = x0 + 2 * p;
    const bool valid = c < a.c_in && y >= 0 && y < a.h && x >= 0 && x < a.w;
    const float* src =
        valid ? a.x + ((static_cast<size_t>(n) * a.c_in + c) * a.h + y) * a.w + x : a.x;
    copy8(xs + cl * T::CSTRIDE + r * T::PITCH + 2 * p, src, valid);
  }
}

template <class T>
__device__ __forceinline__ void fetch_grad(GradStage<T>& s, const WgradArgs& a, int item,
                                           int co0, int tid) {
  int n, ty, tx;
  locate<T>(a, item, n, ty, tx);
  const int hp = a.h / 2, wp = a.w / 2;
#pragma unroll
  for (int i = 0; i < T::G_PER_THREAD; ++i) {
    const int e = tid + i * kThreads;
    const int col = e / T::Q, q = e % T::Q;
    const int co = co0 + col, py = ty * T::PTR + q / T::PTC, px = tx * T::PTC + q % T::PTC;
    const bool valid = e < T::G_FLOATS && co < a.c_out && py < hp && px < wp;
    const size_t at = ((static_cast<size_t>(n) * a.c_out + co) * hp + py) * wp + px;
    s.g[i] = valid ? a.dy[at] : 0.f;
    // 8 marks a position outside the image: no window, no product
    s.code[i] = valid ? a.code[at] : 8u;
  }
}

// g' and the window index of each (position, channel), a position's channels
// consecutive: a warp reads its 4 channels' values in one 16-byte load
template <class T>
__device__ __forceinline__ void store_grad(float* gs, const GradStage<T>& s, int tid) {
  int* const is = reinterpret_cast<int*>(gs + T::G_FLOATS);
#pragma unroll
  for (int i = 0; i < T::G_PER_THREAD; ++i) {
    const int e = tid + i * kThreads;
    if (e >= T::G_FLOATS) break;
    const int at = (e % T::Q) * T::CO_BLK + e / T::Q;
    const unsigned code = s.code[i];
    gs[at] = (code & 8u) ? 0.f : winner_gradient(s.g[i], code);
    is[at] = (code & 8u) ? 4 : static_cast<int>(code & 3u);
  }
}

// acc[ky][kx] += g * patch[ky + DY][kx + DX]: the taps of a window won at (DY, DX)
template <int DY, int DX>
__device__ __forceinline__ void window_taps(float (&acc)[5][5], const float (&p)[6][6],
                                            float g) {
#pragma unroll
  for (int ky = 0; ky < 5; ++ky)
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) acc[ky][kx] = fmaf(g, p[ky + DY][kx + DX], acc[ky][kx]);
}

// the warp's 4 channels at a position: their g' and window index in one
// 16-byte load each, then each window's taps
template <class T>
__device__ __forceinline__ void position_taps(float (&acc)[T::CO_T][5][5],
                                              float (&bsum)[T::CO_T], const float (&p)[6][6],
                                              const float* gs, const int* is) {
  const float4 g4 = *reinterpret_cast<const float4*>(gs);
  const int4 d4 = *reinterpret_cast<const int4*>(is);
  const float g[4] = {g4.x, g4.y, g4.z, g4.w};
  const int d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
  for (int j = 0; j < T::CO_T; ++j) {
    bsum[j] += g[j];
    switch (d[j]) {   // the same for every lane of the warp
      case 0: window_taps<0, 0>(acc[j], p, g[j]); break;
      case 1: window_taps<0, 1>(acc[j], p, g[j]); break;
      case 2: window_taps<1, 0>(acc[j], p, g[j]); break;
      case 3: window_taps<1, 1>(acc[j], p, g[j]); break;
      default: break;
    }
  }
}

// the pipeline of a block's items: item k's input tile and windows are staged
// while item k - 1's are summed; `sum(stage)` sums one item
template <class T, class Sum>
__device__ __forceinline__ void wgrad_items(const WgradArgs& a, float* smem, int split, int ci0,
                                            int co0, int tid, Sum sum) {
  const int items = a.n * a.tiles_y * a.tiles_x;
  GradStage<T> grad;
  if (split < items) {
    stage_patch<T>(smem, a, split, ci0, tid);
    commit_copies();
    fetch_grad<T>(grad, a, split, co0, tid);
    store_grad<T>(smem + T::X_FLOATS, grad, tid);
  }
  int k = 0;
  for (int item = split; item < items; item += a.splits, ++k) {
    const float* const stage = smem + (k & 1) * T::STAGE;
    float* const next = smem + ((k + 1) & 1) * T::STAGE;
    wait_copies();
    __syncthreads();
    const int following = item + a.splits;
    if (following < items) {
      stage_patch<T>(next, a, following, ci0, tid);
      commit_copies();
      fetch_grad<T>(grad, a, following, co0, tid);
    }
    sum(stage);
    if (following < items) store_grad<T>(next + T::X_FLOATS, grad, tid);
  }
}

// the bias gradient of the warp's channels, by the first block of channels
template <class T>
__device__ __forceinline__ void write_bias(const WgradArgs& a, float* out, int ci_tile, int co0,
                                           int warp, int lane, const float (&bacc)[T::CO_T]) {
  if (ci_tile != 0 || lane != 0) return;
#pragma unroll
  for (int j = 0; j < T::CO_T; ++j) {
    const int co = co0 + warp * T::CO_T + j;
    if (co < a.c_out) out[static_cast<size_t>(a.c_out) * a.c_in * 25 + co] = bacc[j];
  }
}

// a lane per input channel, its 25 taps for each of the warp's 4 channels
template <class T>
__global__ void __launch_bounds__(kThreads, T::MIN_BLOCKS) fan_wgrad_kernel(const WgradArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int b = blockIdx.x;
  const int ci_tile = b % a.ci_tiles;
  b /= a.ci_tiles;
  const int co_tile = b % a.co_tiles;
  const int split = b / a.co_tiles;
  const int ci0 = ci_tile * T::CI_T, co0 = co_tile * T::CO_BLK;

  float acc[T::CO_T][5][5];
  float bacc[T::CO_T];    // the bias gradient: the items' sums added
#pragma unroll
  for (int j = 0; j < T::CO_T; ++j) {
    bacc[j] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 5; ++ky)
#pragma unroll
      for (int kx = 0; kx < 5; ++kx) acc[j][ky][kx] = 0.f;
  }

  wgrad_items<T>(a, smem, split, ci0, co0, tid, [&](const float* stage) {
    const float* const xs = stage + lane * T::CSTRIDE;
    const float* const gs = stage + T::X_FLOATS;
    const int* const is = reinterpret_cast<const int*>(gs + T::G_FLOATS);
    float bsum[T::CO_T] = {};
#pragma unroll 1
    for (int qy = 0; qy < T::PTR; ++qy) {
#pragma unroll 1
      for (int qx = 0; qx < T::PTC; ++qx) {
        float p[6][6];
        const float* xp = xs + 2 * qy * T::PITCH + 2 * qx;
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const float2 v = *reinterpret_cast<const float2*>(xp + r * T::PITCH + 2 * m);
            p[r][2 * m] = v.x;
            p[r][2 * m + 1] = v.y;
          }
        const int at = (qy * T::PTC + qx) * T::CO_BLK + warp * T::CO_T;
        position_taps<T>(acc, bsum, p, gs + at, is + at);
      }
    }
#pragma unroll
    for (int j = 0; j < T::CO_T; ++j) bacc[j] += bsum[j];
  });

  const size_t row = static_cast<size_t>(a.c_out) * a.c_in * 25 + a.c_out;
  float* const out = a.partial + static_cast<size_t>(split) * row;
  const int ci = ci0 + lane;
  if (ci < a.c_in) {
#pragma unroll
    for (int j = 0; j < T::CO_T; ++j) {
      const int co = co0 + warp * T::CO_T + j;
      if (co >= a.c_out) continue;
#pragma unroll
      for (int ky = 0; ky < 5; ++ky)
#pragma unroll
        for (int kx = 0; kx < 5; ++kx)
          out[(static_cast<size_t>(co) * a.c_in + ci) * 25 + ky * 5 + kx] = acc[j][ky][kx];
    }
  }
  write_bias<T>(a, out, ci_tile, co0, warp, lane, bacc);
}

// the stem (3 input channels): a lane per tap (ky, kx), its 3 input channels
// for each of the warp's 4 output channels. The winner's place is the same for
// the whole warp, so each product is one load at the lane's offset from it,
// and no branch chooses among the window's places.
template <class T>
__global__ void __launch_bounds__(kThreads, T::MIN_BLOCKS)
    fan_wgrad_taps_kernel(const WgradArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tap = min(lane, 24);
  const int offset = (tap / 5) * T::PITCH + tap % 5;
  int b = blockIdx.x;
  const int co_tile = b % a.co_tiles;
  const int split = b / a.co_tiles;
  const int co0 = co_tile * T::CO_BLK;

  float acc[T::CI_T][T::CO_T];
  float bacc[T::CO_T];    // the bias gradient: the items' sums added
#pragma unroll
  for (int j = 0; j < T::CO_T; ++j) {
    bacc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < T::CI_T; ++c) acc[c][j] = 0.f;
  }

  wgrad_items<T>(a, smem, split, 0, co0, tid, [&](const float* stage) {
    const float* const xs = stage + offset;
    const float* const gs = stage + T::X_FLOATS;
    const int* const is = reinterpret_cast<const int*>(gs + T::G_FLOATS);
    float bsum[T::CO_T] = {};
#pragma unroll 1
    for (int qy = 0; qy < T::PTR; ++qy) {
#pragma unroll 1
      for (int qx = 0; qx < T::PTC; ++qx) {
        const int at = (qy * T::PTC + qx) * T::CO_BLK + warp * T::CO_T;
        const float4 g4 = *reinterpret_cast<const float4*>(gs + at);
        const int4 d4 = *reinterpret_cast<const int4*>(is + at);
        const float g[4] = {g4.x, g4.y, g4.z, g4.w};
        const int d[4] = {d4.x, d4.y, d4.z, d4.w};
        const float* const xq = xs + 2 * qy * T::PITCH + 2 * qx;
#pragma unroll
        for (int j = 0; j < T::CO_T; ++j) {
          bsum[j] += g[j];
          if (d[j] < 4) {     // the same for every lane of the warp
            const float* const xw = xq + (d[j] >> 1) * T::PITCH + (d[j] & 1);
#pragma unroll
            for (int c = 0; c < T::CI_T; ++c)
              acc[c][j] = fmaf(g[j], xw[c * T::CSTRIDE], acc[c][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < T::CO_T; ++j) bacc[j] += bsum[j];
  });

  const size_t row = static_cast<size_t>(a.c_out) * a.c_in * 25 + a.c_out;
  float* const out = a.partial + static_cast<size_t>(split) * row;
  if (lane < 25) {
#pragma unroll
    for (int j = 0; j < T::CO_T; ++j) {
      const int co = co0 + warp * T::CO_T + j;
      if (co >= a.c_out) continue;
#pragma unroll
      for (int c = 0; c < T::CI_T; ++c)
        out[(static_cast<size_t>(co) * a.c_in + c) * 25 + lane] = acc[c][j];
    }
  }
  write_bias<T>(a, out, 0, co0, warp, lane, bacc);
}

struct SumArgs {
  const float* partial;         // (splits, row): dW's partial sums, then db's
  float* dw;                    // (wrow)
  float* db;                    // (row - wrow)
  int splits, groups;            // groups: a power of 2, at most kSumGroupsMax
  long long row, wrow;
};

constexpr int kSumThreads = 256, kSumGroupsMax = 16;

// dW and db: the sum over s of partial[s][e], in double, rounded once. A block
// takes kSumThreads / groups elements; each of its `groups` groups of threads
// sums the splits s = group, group + groups, ... in order, and the first group
// adds the groups' sums in order: the same order, and bits, every run. Many
// splits take many groups, so that no thread walks a long chain of loads.
__global__ void __launch_bounds__(kSumThreads) fan_wgrad_sum_kernel(const SumArgs a) {
  __shared__ double sums[kSumThreads];
  const int lanes = kSumThreads / a.groups;
  const int lane = threadIdx.x % lanes, group = threadIdx.x / lanes;
  const long long e = static_cast<long long>(blockIdx.x) * lanes + lane;
  double sum = 0.0;
  if (e < a.row)
    for (int s = group; s < a.splits; s += a.groups) sum += a.partial[s * a.row + e];
  sums[threadIdx.x] = sum;
  __syncthreads();
  if (group != 0 || e >= a.row) return;
  double total = 0.0;
  for (int g = 0; g < a.groups; ++g) total += sums[g * lanes + lane];
  if (e < a.wrow)
    a.dw[e] = static_cast<float>(total);
  else
    a.db[e - a.wrow] = static_cast<float>(total);
}

// -- launches -----------------------------------------------------------------------

constexpr int kMaxDevices = 64;
constexpr int kDefaultSharedBytes = 48 << 10;

// kKernel on `grid` blocks of `block` threads with `bytes` of dynamic shared
// memory a block, on `stream`; memory above the default 48 KB is allowed once
// for each kernel and device
template <auto kKernel, class Args>
cudaError_t launch(int grid, int block, int bytes, int device, cudaStream_t stream,
                   const Args& args) {
  static bool allowed[kMaxDevices] = {};
  constexpr auto kernel = kKernel;
  if (bytes > kDefaultSharedBytes && !(device < kMaxDevices && allowed[device])) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) allowed[device] = true;
  }
  kernel<<<grid, block, bytes, stream>>>(args);
  return cudaGetLastError();
}

struct TapsArgs {
  const float* w;               // (c_out, c_in, 5, 5)
  float* wt;
  int c_out, c_in, c_pad;
  bool dgrad;
};

// the taps' weights with the output channel last: for the forward wt[ci][t][co]
// = W[co][ci][t]; for the dgrad wt[co][t][ci] = W[co][ci][24 - t], ci padded
// to c_pad with zeros
__global__ void __launch_bounds__(256) fan_taps_kernel(const TapsArgs a) {
  const int total = a.dgrad ? a.c_out * 25 * a.c_pad : a.c_in * 25 * a.c_out;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    if (a.dgrad) {
      const int ci = e % a.c_pad, t = e / a.c_pad % 25, co = e / a.c_pad / 25;
      a.wt[e] = ci < a.c_in ? a.w[(co * a.c_in + ci) * 25 + 24 - t] : 0.f;
    } else {
      const int co = e % a.c_out, t = e / a.c_out % 25, ci = e / a.c_out / 25;
      a.wt[e] = a.w[(co * a.c_in + ci) * 25 + t];
    }
  }
}

cudaError_t launch_taps(const TapsArgs& a, int device, cudaStream_t stream) {
  const int total = a.dgrad ? a.c_out * 25 * a.c_pad : a.c_in * 25 * a.c_out;
  const int blocks = (total + 255) / 256;
  return launch<fan_taps_kernel>(blocks < 256 ? blocks : 256, 256, 0, device, stream, a);
}

template <class T, bool kDgrad>
cudaError_t launch_conv(ConvArgs a, int n, int device, cudaStream_t stream) {
  a.tiles_x = (a.w + T::BC - 1) / T::BC;
  a.tiles_y = (a.h + T::BR - 1) / T::BR;
  a.co_tiles = (a.c_out + T::BCO - 1) / T::BCO;
  a.chunks = (a.c_red + T::CK - 1) / T::CK;
  const long long grid = static_cast<long long>(n) * a.tiles_y * a.tiles_x * a.co_tiles;
  if (grid < 1 || grid > 0x7fffffff) return cudaErrorInvalidValue;
  // sums each stage apart where one chain would round more than cuDNN's sums
  // do by twice (tests/test_torch_gpu.py holds both to a float64 evaluation):
  // the forward past 64 channels, the dgrad past one stage
  if (a.chunks > (kDgrad ? 1 : kForwardChain))
    return launch<fan_conv_kernel<T, kDgrad, true>>(static_cast<int>(grid), kThreads, T::BYTES,
                                                    device, stream, a);
  return launch<fan_conv_kernel<T, kDgrad, false>>(static_cast<int>(grid), kThreads, T::BYTES,
                                                   device, stream, a);
}

template <class T>
void wgrad_plan(WgradArgs& a, int sms) {
  a.tiles_y = (a.h / 2 + T::PTR - 1) / T::PTR;
  a.tiles_x = (a.w / 2 + T::PTC - 1) / T::PTC;
  a.ci_tiles = (a.c_in + T::CI_T - 1) / T::CI_T;
  a.co_tiles = (a.c_out + T::CO_BLK - 1) / T::CO_BLK;
  const long long items = static_cast<long long>(a.n) * a.tiles_y * a.tiles_x;
  const long long per_split = static_cast<long long>(a.ci_tiles) * a.co_tiles;
  // two waves of resident blocks
  const long long want = (2LL * T::MIN_BLOCKS * sms + per_split - 1) / per_split;
  a.splits = static_cast<int>(want < 1 ? 1 : (want > items ? items : want));
}

bool even_sides(int h, int w) { return h >= 2 && w >= 2 && h % 2 == 0 && w % 2 == 0; }

bool wide_wgrad(int c_in) { return c_in % 32 == 0; }

bool wgrad_args(WgradArgs& a, int device) {
  if (!even_sides(a.h, a.w) || a.n < 1 || a.c_out % 16 != 0 ||
      !(a.c_in == 3 || wide_wgrad(a.c_in)))
    return false;
  static int multiprocessors[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return false;
  if (multiprocessors[device] == 0 &&
      cudaDeviceGetAttribute(&multiprocessors[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return false;
  const int sms = multiprocessors[device];
  if (wide_wgrad(a.c_in))
    wgrad_plan<WgradWide>(a, sms);
  else
    wgrad_plan<WgradStem>(a, sms);
  return true;
}

}  // namespace

// The shapes the kernels take: the forward c_in 3 and c_out a multiple of 32,
// or c_out a multiple of 64; the dgrad c_in 3 or a multiple of 32; the wgrad
// c_in 3 or a multiple of 32 and c_out a multiple of 16; even h and w. All tensors
// float32 (codes uint8), contiguous, 16-byte aligned, on CUDA device `device`.
// Each function returns the first CUDA error of its launches (0 = cudaSuccess;
// cudaErrorInvalidValue for a shape it does not take). The library links its
// own CUDA runtime, whose current device is set here.

// x (n, c_in, h, w); w (c_out, c_in, 5, 5); bias (c_out); wt: c_in * 25 * c_out
// floats of scratch, for the taps' weights; y (n, c_out, h/2, w/2); code (n,
// c_out, h/2, w/2).
extern "C" int fan_conv_forward(const float* x, const float* w, const float* bias, float* wt,
                                float* y, unsigned char* code, int n, int c_in, int c_out, int h,
                                int width, int device, cudaStream_t stream) {
  if (n < 1 || !even_sides(h, width) || !(c_in == 3 ? c_out % 32 == 0 : c_out % 64 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaError_t err = launch_taps({w, wt, c_out, c_in, c_out, false}, device, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvArgs a{x, nullptr, wt, bias, y, code, c_in, c_out, c_out, h, width, 0, 0, 0, 0};
  if (c_in == 3)
    err = launch_conv<StemTile, false>(a, n, device, stream);
  else
    err = launch_conv<Wide64Tile, false>(a, n, device, stream);
  return static_cast<int>(err);
}

// dy (n, c_out, h/2, w/2); code (n, c_out, h/2, w/2); w (c_out, c_in, 5, 5); wt:
// c_out * 25 * c_in_pad floats of scratch (c_in_pad = 4 for c_in = 3, else
// c_in), for the flipped taps' weights; dx (n, c_in, h, w).
extern "C" int fan_conv_dgrad(const float* dy, const unsigned char* code, const float* w,
                              float* wt, float* dx, int n, int c_in, int c_out, int h, int width,
                              int device, cudaStream_t stream) {
  if (n < 1 || !even_sides(h, width) || c_out < 1 || !(c_in == 3 || c_in % 32 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int c_pad = c_in == 3 ? 4 : c_in;
  cudaError_t err = launch_taps({w, wt, c_out, c_in, c_pad, true}, device, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvArgs a{dy, code, wt, nullptr, dx, nullptr, c_out, c_in, c_pad, h, width, 0, 0, 0, 0};
  if (c_in == 3)
    err = launch_conv<Narrow4Tile, true>(a, n, device, stream);
  else if (c_in % 64 == 0)
    err = launch_conv<Wide64Tile, true>(a, n, device, stream);
  else
    err = launch_conv<Wide32Tile, true>(a, n, device, stream);
  return static_cast<int>(err);
}

// The number of partial sums (`splits`) the wgrad of this shape leaves; the
// caller allocates `partial` as (splits, c_out * c_in * 25 + c_out) floats.
extern "C" int fan_conv_wgrad_splits(int n, int c_in, int c_out, int h, int w, int device,
                                     int* splits) {
  WgradArgs a{nullptr, nullptr, nullptr, nullptr, n, c_in, c_out, h, w, 0, 0, 0, 0, 0};
  if (!wgrad_args(a, device)) return static_cast<int>(cudaErrorInvalidValue);
  *splits = a.splits;
  return 0;
}

// dy, code (n, c_out, h/2, w/2); x (n, c_in, h, w); partial as above; dw
// (c_out, c_in, 5, 5); db (c_out).
extern "C" int fan_conv_wgrad(const float* dy, const unsigned char* code, const float* x,
                              float* partial, float* dw, float* db, int n, int c_in, int c_out,
                              int h, int w, int splits, int device, cudaStream_t stream) {
  WgradArgs a{dy, code, x, partial, n, c_in, c_out, h, w, 0, 0, 0, 0, 0};
  if (!wgrad_args(a, device) || a.splits != splits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long grid = static_cast<long long>(a.splits) * a.co_tiles * a.ci_tiles;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (wide_wgrad(c_in))
    err = launch<fan_wgrad_kernel<WgradWide>>(static_cast<int>(grid), kThreads,
                                              WgradWide::BYTES, device, stream, a);
  else
    err = launch<fan_wgrad_taps_kernel<WgradStem>>(static_cast<int>(grid), kThreads,
                                                   WgradStem::BYTES, device, stream, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wrow = static_cast<long long>(c_out) * c_in * 25;
  int groups = 1;
  while (groups < kSumGroupsMax && groups * 16 < splits) groups *= 2;
  const SumArgs sum{partial, dw, db, splits, groups, wrow + c_out, wrow};
  const long long lanes = kSumThreads / groups;
  const long long blocks = (sum.row + lanes - 1) / lanes;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch<fan_wgrad_sum_kernel>(static_cast<int>(blocks), kSumThreads, 0, device, stream, sum));
}
