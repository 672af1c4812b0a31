// Fused differentiable-JPEG core for Hopper (sm_90a): per 8x8 block of each
// centered YCbCr plane, 2-D DCT, divide by the plane's quantization table,
// round half to even, multiply back, inverse 2-D DCT. Writes the
// reconstruction and the dequantized coefficients, both (P, H, W) float32.
//
// Replaces the TPU kernel neural_imaging_tpu/ops/pallas/jpeg8x8.py
// (_strip_kernel). That kernel expressed the per-block column DCT as a
// (W, W) block-diagonal matrix product and tiled the q-table to (P, 8, W) to
// fit the TPU's matrix unit and (8, 128) layout. Here each thread works on
// one column of one 8x8 block with 8-term FMA dot products, and reads the
// (8, 8) table of its plane: the block-diagonal form would cost O(W^2)
// memory and W/8 times the arithmetic.
//
// Bound: ~67 FLOP per pixel against 12 bytes moved (read 4, write 8), far
// below the H100's ~20 FLOP/B f32 ridge, so the kernel is memory-bound and
// uses no tensor cores. Design for that: one block of 128 threads covers an
// 8-row x 128-column tile; each row is loaded and both outputs stored
// coalesced along W, and the tile's intermediate coefficients stay in
// registers and shared memory.
//
// Numerics: the DCT matrix comes from the caller (numpy float64 cast to
// float32, the reference's matrix), the division is IEEE (build without
// --use_fast_math), and rintf rounds half to even like jnp.round.
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;  // tile columns = threads per block = 16 blocks of 8

__global__ void __launch_bounds__(kTileW)
jpeg8x8_kernel(const float* __restrict__ x, const float* __restrict__ q,
               const float* __restrict__ dct, float* __restrict__ y,
               float* __restrict__ c, int H, int W) {
  __shared__ float s_d[64];            // D[k][m], row-major
  __shared__ float s_q[64];            // this plane's table, [k][l]
  __shared__ float s_t[8][kTileW];     // row-pass exchange between threads

  const int tx = threadIdx.x;
  const int p = blockIdx.z;
  const int row0 = blockIdx.y * 8;
  const int col = blockIdx.x * kTileW + tx;
  const bool active = col < W;        // W % 8 == 0: whole 8x8 blocks are masked
  const int base = tx & ~7;           // first tile column of this thread's block
  const int l = tx & 7;               // column within the block

  if (tx < 64) {
    s_d[tx] = dct[tx];
    s_q[tx] = q[p * 64 + tx];
  }

  const size_t plane = static_cast<size_t>(p) * H * W;
  const size_t at = plane + static_cast<size_t>(row0) * W + col;
  float v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) v[m] = active ? x[at + static_cast<size_t>(m) * W] : 0.f;
  __syncthreads();

  // forward column pass, own column: t = D @ strip
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) acc = fmaf(s_d[k * 8 + m], v[m], acc);
    s_t[k][tx] = acc;
  }
  __syncthreads();

  // forward row pass: X[k][l] = sum_m t[k][m] D[l][m]
  float xq[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) acc = fmaf(s_t[k][base + m], s_d[l * 8 + m], acc);
    xq[k] = acc;
  }
  __syncthreads();  // every thread has read s_t before it is overwritten

  // quantize / dequantize; store the coefficients in the strip layout
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float qk = s_q[k * 8 + l];
    const float r = rintf(xq[k] / qk) * qk;
    s_t[k][tx] = r;
    if (active) c[at + static_cast<size_t>(k) * W] = r;
  }
  __syncthreads();

  // inverse row pass: t2[k][l] = sum_j Xq[k][j] D[j][l]
  float t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(s_t[k][base + j], s_d[j * 8 + l], acc);
    t[k] = acc;
  }

  // inverse column pass, own column: y = D^T @ t2
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(s_d[k * 8 + m], t[k], acc);
    if (active) y[at + static_cast<size_t>(m) * W] = acc;
  }
}

}  // namespace

// x, y, c: (P, H, W) float32 contiguous; q: (P, 8, 8); dct: (8, 8); all on
// CUDA device `device`. The caller checks H % 8 == 0, W % 8 == 0,
// 0 < P <= 65535 and 0 < H / 8 <= 65535. The library links its own CUDA
// runtime, whose current device is set here, not by the caller's framework.
// Returns the first CUDA error of the launch (0 = cudaSuccess).
extern "C" int jpeg8x8_forward(const float* x, const float* q, const float* dct,
                               float* y, float* c, int P, int H, int W,
                               int device, cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((W + kTileW - 1) / kTileW, H / 8, P);
  jpeg8x8_kernel<<<grid, kTileW, 0, stream>>>(x, q, dct, y, c, H, W);
  return static_cast<int>(cudaGetLastError());
}
