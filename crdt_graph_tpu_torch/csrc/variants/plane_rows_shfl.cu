// Kernel 1 with each row's index broadcast inside the warp: the design
// that csrc/plane_rows.cu's L1 broadcast was measured against (PERF.md,
// section 6).  The package does not build it; it builds and runs in that
// file's place (same entry points, same contract), in a copy of the
// package that `python -m crdt_graph_tpu_torch.bench.kerneltime --roots`
// times beside the checkout (the module's docstring has the commands).
//
// The difference is in kernel 1 only.  In csrc/plane_rows.cu every
// thread of a row loads the row's index (the row's threads share the L1
// line).  Here a row's threads are padded to a group of G lanes, G the
// power of two at or above the row's chunk count (at most 32), so that
// no row straddles a warp: lane 0 of the group loads and clamps the
// index and __shfl_sync hands the source row to the others.  Lanes past
// the row's chunks move nothing.  Rows of more than 32 chunks keep the
// L1 broadcast.  Kernel 2 is unchanged.
#include "common.cuh"

#define PLANE_ROWS_THREADS 256      // threads a block of kernel 1
#define PLANE_ROWS_PER_THREAD 4     // rows in flight a thread of kernel 1
#define PLANE_ROWS_VEC_BYTES 16     // kernel 1's wide access: two columns
#define PLANE_ROWS_STREAMING_STORES 1   // 0: plain stores, not __stcs
#define PLANE_ROWS2_THREADS 256     // threads a block of kernel 2

// Kernel 1's launch geometry for C columns: the access width in bytes,
// threads a row (each moves chunk x, x + threads, ... of the row's
// chunks), rows a block, rows a thread.  aligned16: plane and out both
// start on 16-byte boundaries.
struct RowPlan {
  int vec_bytes, threads_per_row, rows_per_block, rows_per_thread;
};

static RowPlan plane_rows_plan(int64_t C, bool aligned16) {
  RowPlan p;
  p.vec_bytes = (C % 2 == 0 && aligned16) ? PLANE_ROWS_VEC_BYTES : 8;
  const int64_t chunks = C / (p.vec_bytes / 8);
  int g = 1;
  while (g < chunks && g < 32) g *= 2;
  p.threads_per_row =
      chunks <= 32 ? g
                   : (int)(chunks < PLANE_ROWS_THREADS ? chunks
                                                       : PLANE_ROWS_THREADS);
  p.rows_per_block = PLANE_ROWS_THREADS / p.threads_per_row;
  p.rows_per_thread = PLANE_ROWS_PER_THREAD;
  return p;
}

template <typename V>
__device__ __forceinline__ void store_row(V* p, const V& v) {
#if PLANE_ROWS_STREAMING_STORES
  __stcs(p, v);
#else
  *p = v;
#endif
}

// out[t, :] = plane[jax_row(idx[t]), :], the row cut into W chunks of V.
// kSmall: R <= 2^31 - 1, so the index clamps in 32 bits.
template <typename V, bool kSmall>
__global__ void __launch_bounds__(PLANE_ROWS_THREADS)
plane_rows_kernel(const V* __restrict__ plane, int64_t R, int64_t W,
                  const int32_t* __restrict__ idx, int64_t T,
                  V* __restrict__ out) {
  const int64_t ny = blockDim.y;
  const int64_t step = ny * PLANE_ROWS_PER_THREAD;
  // a group of g = blockDim.x lanes (a power of two, 2 to 32) serves one
  // row: lane 0 loads its index, the others take it by shuffle.  The
  // loop runs alike in every thread of the block, so each shuffle has
  // the whole warp.
  const int g = blockDim.x;
  const bool shfl = g > 1 && g <= 32;
  for (int64_t b0 = (int64_t)blockIdx.x * step; b0 < T;
       b0 += step * gridDim.x) {
    const int64_t t0 = b0 + threadIdx.y;
    int64_t src[PLANE_ROWS_PER_THREAD];   // first chunk of each source row
#pragma unroll
    for (int k = 0; k < PLANE_ROWS_PER_THREAD; ++k) {
      const int64_t t = t0 + k * ny;
      int64_t row = 0;
      if (t < T && (!shfl || threadIdx.x == 0)) {
        const int32_t i = __ldg(idx + t);
        row = kSmall ? (int64_t)jax_row32(i, (int)R) : jax_row(i, R);
      }
      if (shfl) row = __shfl_sync(0xffffffffu, row, 0, g);
      src[k] = row * W;
    }
    for (int64_t x = threadIdx.x; x < W; x += blockDim.x) {
      V v[PLANE_ROWS_PER_THREAD];
#pragma unroll
      for (int k = 0; k < PLANE_ROWS_PER_THREAD; ++k)
        if (t0 + k * ny < T) v[k] = __ldg(plane + src[k] + x);
#pragma unroll
      for (int k = 0; k < PLANE_ROWS_PER_THREAD; ++k)
        if (t0 + k * ny < T) store_row(out + (t0 + k * ny) * W + x, v[k]);
    }
  }
}

__global__ void plane_rows2_kernel(const int64_t* __restrict__ plane,
                                   int64_t R, int64_t C,
                                   const int32_t* __restrict__ idx,
                                   int64_t T, int64_t* __restrict__ out,
                                   int64_t* __restrict__ out2, int hop_col) {
  const int64_t total = T * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t t = e / C;
    const int64_t c = e - t * C;
    const int64_t* row = plane + jax_row((int64_t)__ldg(idx + t), R) * C;
    out[e] = ld_i64(row + c);
    const int64_t hop = ld_i64(row + hop_col);
    int64_t v = 0;
    if (hop >= 0) v = ld_i64(plane + (hop < R ? hop : R - 1) * C + c);
    out2[e] = v;
  }
}

template <typename V>
static void launch_rows(const RowPlan& p, const void* plane, int64_t R,
                        int64_t C, const void* idx, int64_t T, void* out,
                        cudaStream_t s) {
  const int64_t W = C / (p.vec_bytes / 8);
  const dim3 block(p.threads_per_row, p.rows_per_block);
  const unsigned int blocks =
      grid_blocks(T, p.rows_per_block * p.rows_per_thread);
  if (R <= 2147483647LL)
    plane_rows_kernel<V, true><<<blocks, block, 0, s>>>(
        (const V*)plane, R, W, (const int32_t*)idx, T, (V*)out);
  else
    plane_rows_kernel<V, false><<<blocks, block, 0, s>>>(
        (const V*)plane, R, W, (const int32_t*)idx, T, (V*)out);
}

// out2 == nullptr: one hop (plane_rows); else two hops (plane_rows2).
extern "C" int crdt_plane_rows(const void* plane, int64_t R, int64_t C,
                               const void* idx, int64_t T, void* out,
                               void* out2, int hop_col, void* stream) {
  if (R < 1 || C < 1 || T < 0 || (out2 && (hop_col < 0 || hop_col >= C)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out2) {
    const unsigned int blocks = grid_blocks(T * C, PLANE_ROWS2_THREADS);
    plane_rows2_kernel<<<blocks, PLANE_ROWS2_THREADS, 0, s>>>(
        (const int64_t*)plane, R, C, (const int32_t*)idx, T,
        (int64_t*)out, (int64_t*)out2, hop_col);
    return (int)cudaGetLastError();
  }
  const bool aligned16 = ((uintptr_t)plane % 16 == 0) &&
                         ((uintptr_t)out % 16 == 0);
  const RowPlan p = plane_rows_plan(C, aligned16);
  if (p.vec_bytes == 16)
    launch_rows<longlong2>(p, plane, R, C, idx, T, out, s);
  else
    launch_rows<long long>(p, plane, R, C, idx, T, out, s);
  return (int)cudaGetLastError();
}

// Kernel 1's plan for C columns, as crdt_plane_rows chooses it: writes
// {vector bytes, threads a row, rows a block, rows a thread} to plan[4].
extern "C" int crdt_plane_rows_plan(int64_t C, int aligned16, int* plan) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const RowPlan p = plane_rows_plan(C, aligned16 != 0);
  plan[0] = p.vec_bytes;
  plan[1] = p.threads_per_row;
  plan[2] = p.rows_per_block;
  plan[3] = p.rows_per_thread;
  return 0;
}

// The batched entry point the package binds, for this variant built in
// place of csrc/plane_rows.cu: one launch a document (the variant is
// timed on one document).
extern "C" int crdt_plane_rows_batched(const void* plane, int64_t B,
                                       int64_t R, int64_t C, const void* idx,
                                       int64_t T, void* out, void* out2,
                                       int hop_col, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  for (int64_t b = 0; b < B; ++b) {
    const int e = crdt_plane_rows(
        (const int64_t*)plane + b * R * C, R, C, (const int32_t*)idx + b * T,
        T, (int64_t*)out + b * T * C,
        out2 ? (void*)((int64_t*)out2 + b * T * C) : nullptr, hop_col,
        stream);
    if (e) return e;
  }
  return 0;
}
