// A host stand-in for the CUDA runtime, enough to compile csrc/fan_conv.cu with
// g++ (tests/support/fan_conv_host.py): a kernel launch runs its blocks on the
// CPU one after another, its threads as std::threads that meet at
// std::barrier for __syncthreads, over one block's shared memory. Copies are synchronous (the
// sources' host branches). For checking the kernels' indexing against their
// plain versions on the CPU, at small shapes; it says nothing of speed.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

struct HostDim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local HostDim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local float4* host_shared = nullptr;
inline thread_local std::barrier<>* host_barrier = nullptr;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
using std::max;
using std::min;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
constexpr int kHostSharedBytes = 232448;    // an H100 block's most
inline int host_multiprocessors = 132;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = host_multiprocessors;
  return cudaSuccess;
}
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int bytes) {
  return bytes > kHostSharedBytes ? cudaErrorInvalidValue : cudaSuccess;
}

// kernel<<<grid, block, bytes>>>(args): the blocks one after another, run by
// `block` threads that meet between blocks, over shared memory filled with
// NaN bits before each block, so that a read of shared memory never written
// shows
template <class Args>
void host_launch(void (*kernel)(Args), int grid, int block, int bytes, const Args& args) {
  std::vector<float4> shared(std::max(bytes, 1 << 16) / 16 + 1);
  std::memset(shared.data(), 0xff, shared.size() * sizeof(float4));
  std::barrier<> barrier(block);
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      blockDim.x = block;
      gridDim.x = grid;
      host_shared = shared.data();
      host_barrier = &barrier;
      for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        kernel(args);
        barrier.arrive_and_wait();
        if (t == 0) std::memset(shared.data(), 0xff, shared.size() * sizeof(float4));
        barrier.arrive_and_wait();
      }
    });
  for (auto& thread : threads) thread.join();
}
