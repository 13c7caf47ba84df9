// Shared helpers of the package's CUDA kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The row a JAX gather reads for index i of an axis of length n
// (``x[i]`` in jax.numpy): a negative index wraps once, and whatever is
// still outside [0, n) clamps to the nearest end.  n >= 1.
__device__ __forceinline__ int64_t jax_row(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// jax_row in 32 bits, for n <= 2^31 - 1 (i + n cannot overflow).
__device__ __forceinline__ int jax_row32(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Read-only-path loads; int64_t is `long` on LP64, so it goes through
// the `long long` overload.
__device__ __forceinline__ int64_t ld_i64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// Blocks for a 1-D grid-stride launch over `work` items.
inline unsigned int grid_blocks(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  const int64_t cap = 1 << 20;
  return (unsigned int)(b < 1 ? 1 : (b > cap ? cap : b));
}
