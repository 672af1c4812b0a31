// Fused differentiable-JPEG core for Hopper (sm_90a): per 8x8 block of each
// centered YCbCr plane, 2-D DCT, divide by the plane's quantization table,
// round half to even, multiply back, inverse 2-D DCT. Writes the
// reconstruction and the dequantized coefficients, both (P, H, W) float32.
//
// Replaces the TPU kernel neural_imaging_tpu/ops/pallas/jpeg8x8.py
// (_strip_kernel). That kernel expressed the per-block column DCT as a
// (W, W) block-diagonal matrix product and tiled the q-table to (P, 8, W) to
// fit the TPU's matrix unit and (8, 128) layout. Here 8 lanes of a warp
// share one 8x8 block and do the four passes as 8-term FMA dot products: the
// block-diagonal form would cost O(W^2) memory and W/8 times the arithmetic.
//
// Bound: ~67 FLOP per pixel against 12 bytes moved (read 4, write 8), far
// below the H100's ~20 FLOP/B f32 ridge, so the kernel is memory-bound and
// uses no tensor cores (TF32 would also change the numbers). At ~2.3 warp
// instructions a pixel (280 of a group's ~590 are its FMAs) it also needs
// its instruction slots spent with little waste to keep enough bytes in
// flight. Design for that:
// - a warp takes 4 neighbouring 8x8 blocks ("tiles", a group) at a time,
//   lane 8b + l on tile b, and walks groups at a stride of the grid's warps;
// - the pixels come in by cp.async, 16 bytes a copy, into a warp-private
//   ring of 3 shared stages: while a warp computes one group its next ones
//   are in flight, in no register. Lane i copies, and later stores, 16-byte
//   chunk i % 8 of rows i / 8 and i / 8 + 4 of the group, so that every
//   warp copy and store covers 4 whole 128-byte rows;
// - in its stage a group is transposed in place: lane l reads column l for
//   the column passes and row l for the row passes. Stage rows are 36
//   floats apart, so that the column reads (4 bytes a lane), the row reads
//   and the chunks (16) fall in 32 different banks, and every lane's offsets
//   are one base plus constants. Lanes order each other's reads and writes
//   with __syncwarp; there is no block-wide barrier;
// - both outputs leave through the stage too: a lane puts its row of the
//   coefficients, or its column of the reconstruction, in place, and the
//   chunks are stored as they came in;
// - the DCT matrix is compiled in, each entry an immediate operand of its
//   FMA, taking no register and no load (as a kernel parameter the compiler
//   hoists its 64 values into registers); each lane's q-table row is two
//   16-byte broadcast loads, and tile indices divide by multiply and shift;
// - the caller sizes the grid and the block from (P, H, W) and the kernel's
//   residency (ops/hopper/jpeg8x8.py::launch_plan): at most 2 or 3 groups a
//   warp for large launches, small blocks spread over every SM for small
//   ones. The 32-bit tile index is the only limit on the shape.
//
// Numerics: the same FMA chains in the same order as the first design of
// this kernel (each output a chain from 0 over m, j or k ascending), so the
// two give the same bits. The DCT matrix is the reference's (numpy float64
// cast to float32, ops/dct.py::dct_matrix): the launcher refuses a caller's
// matrix that differs from the compiled one in any bit. The division is IEEE
// (build without --use_fast_math), and rintf rounds half to even like
// jnp.round.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxBlock = 256;      // threads: 8 warps
constexpr int kTilesPerWarp = 4;
constexpr int kStages = 3;
// a stage: 8 rows of 32 floats (4 tiles x 8 columns) at a stride of 36, then
// the Place of each of the group's 4 tiles (4 words each)
constexpr int kRow = 36;
constexpr int kPlaces = 8 * kRow;
constexpr int kStage = kPlaces + 4 * kTilesPerWarp;   // floats

// D[k][m] = c_k cos((2m + 1) k pi / 16), row-major, as float32: 1/sqrt(8)
// in row 0, c_k = 1/2 otherwise; seven magnitudes in all
#define K1_DCT_MATRIX {                                                          \
  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,               \
  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,               \
  0x1.f6297cp-2f,  0x1.a9b662p-2f,  0x1.1c73b4p-2f,  0x1.8f8b84p-4f,               \
  -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b662p-2f, -0x1.f6297cp-2f,              \
  0x1.d906bcp-2f,  0x1.87de2ap-3f,  -0x1.87de2ap-3f, -0x1.d906bcp-2f,              \
  -0x1.d906bcp-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f,  0x1.d906bcp-2f,               \
  0x1.a9b662p-2f,  -0x1.8f8b84p-4f, -0x1.f6297cp-2f, -0x1.1c73b4p-2f,              \
  0x1.1c73b4p-2f,  0x1.f6297cp-2f,  0x1.8f8b84p-4f,  -0x1.a9b662p-2f,              \
  0x1.6a09e6p-2f,  -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,               \
  0x1.6a09e6p-2f,  -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,               \
  0x1.1c73b4p-2f,  -0x1.f6297cp-2f, 0x1.8f8b84p-4f,  0x1.a9b662p-2f,               \
  -0x1.a9b662p-2f, -0x1.8f8b84p-4f, 0x1.f6297cp-2f,  -0x1.1c73b4p-2f,              \
  0x1.87de2ap-3f,  -0x1.d906bcp-2f, 0x1.d906bcp-2f,  -0x1.87de2ap-3f,              \
  -0x1.87de2ap-3f, 0x1.d906bcp-2f,  -0x1.d906bcp-2f, 0x1.87de2ap-3f,               \
  0x1.8f8b84p-4f,  -0x1.1c73b4p-2f, 0x1.a9b662p-2f,  -0x1.f6297cp-2f,              \
  0x1.f6297cp-2f,  -0x1.a9b662p-2f, 0x1.1c73b4p-2f,  -0x1.8f8b84p-4f}

constexpr float kHostDct[64] = K1_DCT_MATRIX;

// n / d for n < 2^31 by one wide multiply: m = ceil(2^(31 + s) / d) with s =
// ceil(log2 d) (m < 2^32, and n (m d - 2^(31 + s)) < 2^(31 + s))
struct Divisor {
  unsigned d, m, shift;
};

Divisor make_divisor(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  return {d, static_cast<unsigned>(((1ull << (31 + s)) + d - 1) / d), 31 + s};
}

__device__ __forceinline__ unsigned divide(unsigned n, const Divisor& d) {
  return static_cast<unsigned>((static_cast<unsigned long long>(n) * d.m) >> d.shift);
}

// where tile b of group g lies: tile 4g + b, the offset of its first pixel,
// its plane, and whether it exists (the last group may hold fewer than 4)
struct Place {
  unsigned long long at;
  unsigned p, active;
};

__device__ __forceinline__ Place place(unsigned g, int b, int H, int W, const Divisor& tiles_w,
                                       const Divisor& tiles_plane, unsigned tiles) {
  const unsigned t = g * kTilesPerWarp + b;
  const unsigned active = t < tiles;
  const unsigned tt = active ? t : 0;
  const unsigned p = divide(tt, tiles_plane);
  const unsigned r = tt - p * tiles_plane.d;
  const unsigned bh = divide(r, tiles_w);
  const unsigned bw = r - bh * tiles_w.d;
  return {(static_cast<unsigned long long>(p) * H + 8 * bh) * W + 8 * bw, p, active};
}

// lane i's chunks of a group: columns 4 (i % 8) to 4 (i % 8) + 3 of rows
// i / 8 and i / 8 + 4, in tile (i % 8) / 2, 4 (i % 2) columns into it
__device__ __forceinline__ int chunk_tile(int lane) { return (lane & 7) >> 1; }

__device__ __forceinline__ float* chunk_slot(float* stage, int lane) {
  return stage + (lane >> 3) * kRow + 4 * (lane & 7);
}

// lane i's share of group g's copy into `stage`: its two chunks (zeros for a
// missing tile), and the Place of its chunks' tile by one lane of each tile;
// then close the lane's copy group
__device__ __forceinline__ void copy_group(float* stage, const float* x, unsigned g,
                                           unsigned groups, int lane, int H, int W,
                                           const Divisor& tiles_w, const Divisor& tiles_plane,
                                           unsigned tiles) {
  if (g < groups) {
    const Place at = place(g, chunk_tile(lane), H, W, tiles_w, tiles_plane, tiles);
    const float* src =
        at.active ? x + at.at + static_cast<size_t>(lane >> 3) * W + 4 * (lane & 1) : x;
    const int bytes = at.active ? 16 : 0;
    float* dst = chunk_slot(stage, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * kRow * h));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(to), "l"(src + static_cast<size_t>(4 * h) * W), "r"(bytes)
                   : "memory");
    }
    if (lane < 8 && !(lane & 1))
      *reinterpret_cast<uint4*>(stage + kPlaces + 4 * chunk_tile(lane)) =
          make_uint4(static_cast<unsigned>(at.at), static_cast<unsigned>(at.at >> 32), at.p,
                     at.active);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a group's output from its stage, chunk by chunk as copy_group brought the
// input in
__device__ __forceinline__ void store_chunks(float* __restrict__ out, float* stage, int lane,
                                             int W) {
  const uint4 pl = *reinterpret_cast<const uint4*>(stage + kPlaces + 4 * chunk_tile(lane));
  if (!pl.w) return;
  float* dst = out + ((static_cast<unsigned long long>(pl.y) << 32 | pl.x) +
                      static_cast<size_t>(lane >> 3) * W + 4 * (lane & 1));
  const float* chunk = chunk_slot(stage, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(4 * h) * W) =
        *reinterpret_cast<const float4*>(chunk + 4 * kRow * h);
}

__global__ void __launch_bounds__(kMaxBlock)
jpeg8x8_kernel(const float* __restrict__ x, const float* __restrict__ q,
               float* __restrict__ y, float* __restrict__ c, int H, int W,
               Divisor tiles_w, Divisor tiles_plane, unsigned tiles) {
  constexpr float D[64] = K1_DCT_MATRIX;
  extern __shared__ __align__(16) float s_ring[];
  const int lane = threadIdx.x & 31;
  const int l = lane & 7;                       // the lane's row of its tile
  float* ring = s_ring + (threadIdx.x >> 5) * (kStages * kStage);
  const unsigned warps = gridDim.x * (blockDim.x >> 5);
  const unsigned groups = (tiles + kTilesPerWarp - 1) / kTilesPerWarp;
  const unsigned first = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    copy_group(ring + i * kStage, x, first + i * warps, groups, lane, H, W, tiles_w,
               tiles_plane, tiles);
  float* buf = ring;                            // this group's stage
  float* refill = ring + (kStages - 1) * kStage;
  for (unsigned g = first; g < groups; g += warps) {
    // refill the stage the previous group left (its reads ended at the
    // __syncwarp closing the last step), then wait for this group's copy
    copy_group(refill, x, g + (kStages - 1) * warps, groups, lane, H, W, tiles_w, tiles_plane,
               tiles);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    __syncwarp();
    float* column = buf + lane;                 // lane l's column: column[m * kRow]
    float* row = buf + l * kRow + 8 * (lane >> 3);   // its row: row[0..7]
    const unsigned plane = reinterpret_cast<const unsigned*>(buf + kPlaces)[4 * (lane >> 3) + 2];

    // forward column pass, lane l on column l: t[k] = sum_m D[k][m] x[m][l];
    // t goes where the column was, which only this lane reads
    float v[8], s[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = column[m * kRow];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) acc = fmaf(D[k * 8 + m], v[m], acc);
      s[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) column[k * kRow] = s[k];
    __syncwarp();

    // lane l on row l of t: forward row pass X[l][j] = sum_m t[l][m] D[j][m],
    // quantize (the coefficients go out through the stage), inverse row pass
    // t2[l][j] = sum_i Xq[l][i] D[i][j]; only this lane reads its row
    {
      const float4 lo = *reinterpret_cast<const float4*>(row);
      const float4 hi = *reinterpret_cast<const float4*>(row + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) acc = fmaf(v[m], D[j * 8 + m], acc);
      s[j] = acc;
    }
    const float4* qrow =
        reinterpret_cast<const float4*>(q + static_cast<size_t>(plane) * 64 + 8 * l);
    const float4 q0 = __ldg(qrow), q1 = __ldg(qrow + 1);
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = rintf(s[j] / qv[j]) * qv[j];
    *reinterpret_cast<float4*>(row) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(row + 4) = make_float4(s[4], s[5], s[6], s[7]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(s[i], D[i * 8 + j], acc);
      v[j] = acc;
    }
    __syncwarp();
    store_chunks(c, buf, lane, W);
    __syncwarp();
    *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);   // t2
    *reinterpret_cast<float4*>(row + 4) = make_float4(v[4], v[5], v[6], v[7]);
    __syncwarp();

    // inverse column pass, lane l on column l: y[m][l] = sum_k D[k][m] t2[k][l],
    // put over the column, then stored by chunks
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = column[k * kRow];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(D[k * 8 + m], v[k], acc);
      s[m] = acc;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) column[m * kRow] = s[m];
    __syncwarp();
    store_chunks(y, buf, lane, W);
    __syncwarp();
    refill = buf;
    buf = buf + kStage == ring + kStages * kStage ? ring : buf + kStage;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

size_t buffer_bytes(int block) {
  return static_cast<size_t>(block / 32) * kStages * kStage * sizeof(float);
}

}  // namespace

// The kernel's residency on CUDA device `device` at `block` threads a block:
// *sms the device's SMs, *warps the warps an SM keeps resident. Returns the
// first CUDA error (0 = cudaSuccess).
extern "C" int jpeg8x8_residency(int device, int block, int* sms, int* warps) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jpeg8x8_kernel, block,
                                                      buffer_bytes(block));
  *warps = blocks * (block / 32);
  return static_cast<int>(err);
}

// x, y, c: (P, H, W) float32 contiguous, 16-byte aligned; q: (P, 8, 8), 16-byte
// aligned; all on CUDA device `device`. dct: the caller's (8, 8) matrix in
// host memory, which must be the compiled one bit for bit. The caller checks
// H % 8 == 0, W % 8 == 0, P * (H / 8) * (W / 8) < 2^31 and grid * block <=
// 2^31, and picks grid and block (block <= 256, a multiple of 32). The
// library links its own CUDA runtime, whose current device is set here, not
// by the caller's framework. Returns the first CUDA error of the launch (0 =
// cudaSuccess; cudaErrorInvalidValue for another DCT matrix).
extern "C" int jpeg8x8_forward(const float* x, const float* q, const float* dct, float* y,
                               float* c, int P, int H, int W, int grid, int block, int device,
                               cudaStream_t stream) {
  if (std::memcmp(dct, kHostDct, sizeof kHostDct) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned tiles_w = static_cast<unsigned>(W) / 8;
  const unsigned tiles_plane = static_cast<unsigned>(H) / 8 * tiles_w;
  jpeg8x8_kernel<<<grid, block, buffer_bytes(block), stream>>>(
      x, q, y, c, H, W, make_divisor(tiles_w), make_divisor(tiles_plane),
      static_cast<unsigned>(P) * tiles_plane);
  return static_cast<int>(cudaGetLastError());
}
