// Node-frame row gather, one hop or two.
//
// Replaces the Pallas kernels of crdt_graph_tpu/ops/fused_resolve.py:
//   plane_rows  (_kernel,  via _pallas_call)  -- out[t, :] = plane[idx[t], :]
//   plane_rows2 (_kernel2, via _pallas_call2) -- the same, then a second
//     hop through the gathered row's hop column:
//       out2[t, :] = plane[clip(out[t, hop_col], 0, R-1), :], or zeros
//       where that hop is negative.
// Semantics are the reference's _lax_rows / _lax_rows2 exactly, JAX's
// index rule included (a negative index wraps once, the rest clamps).
//
// What bounds them: bytes.  Per output row they read one index (4 B) and
// one or two random plane rows (C * 8 B each) and write one or two rows.
// At the delete leg's shape (C = 2, T ~ 1.06 M) the one-hop gather moves
// ~37 MB, ~11 us at 3.35 TB/s; at the fused leg's (C = 6, T = M =
// 1,000,002) the two-hop sweep moves ~196 MB, ~58 us.  There is no
// arithmetic.
//
// The TPU kernels staged a bounded window of the plane in VMEM and
// gathered through an exact f32 one-hot MXU product on 16-bit limbs, with
// span and hop-locality checks that sent other inputs to a fallback.
// Hopper loads int64 from any address, so none of that survives, and
// every index works: there is no fallback.
//
// Kernel 1 (plane_rows_kernel) is laid out for the card's memory system:
//   - a row is cut into chunks of one access each: 16 bytes (two columns,
//     one longlong2) when C is even and plane and out start on 16-byte
//     boundaries, else 8 bytes (one column).  threadIdx.x is the chunk,
//     threadIdx.y the row within the block, so no thread divides by C;
//   - a thread loads its rows' indices first and clamps each once, then
//     issues all its rows' loads, then all their stores, so
//     PLANE_ROWS_PER_THREAD random loads are in flight a thread.  The
//     k-th row of every thread lies k * blockDim.y rows on, so each of a
//     warp's index loads and stores is contiguous;
//   - the threads of one row each read its index; they share the L1 line
//     (a warp-shuffle broadcast, csrc/variants/plane_rows_shfl.cu,
//     measured slower);
//   - stores are evict-first (__stcs): the output is not read again by
//     this kernel, so the L2 keeps the plane and the index (measured
//     faster than plain stores, PERF.md section 6).
// ``row_plan`` in ops/fused_resolve.py mirrors plane_rows_plan below.
//
// Kernel 2 (plane_rows2_kernel) keeps the element-a-thread layout: a group
// of C consecutive threads serves one output row, one column each.
//
// Both take a leading document axis (the batched merge's [B, R, C] plane
// and [B, T] index): blockIdx.y walks the documents, and document b's
// plane, index and output start b * R * C, b * T and b * T * C elements
// on.  Every index is clamped against the document's own R before that
// offset is added, so no index, however wild, reads a neighbour's rows.
// One document is the batch of one (crdt_plane_rows).
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
  p.threads_per_row =
      (int)(chunks < PLANE_ROWS_THREADS ? chunks : PLANE_ROWS_THREADS);
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

// out[t, :] = plane[jax_row(idx[t]), :] for one document, the row cut
// into W chunks of V.  kSmall: R <= 2^31 - 1, so the index clamps in 32
// bits.
template <typename V, bool kSmall>
__device__ __forceinline__ void doc_rows(const V* __restrict__ plane,
                                         int64_t R, int64_t W,
                                         const int32_t* __restrict__ idx,
                                         int64_t T, V* __restrict__ out) {
  const int64_t ny = blockDim.y;
  const int64_t step = ny * PLANE_ROWS_PER_THREAD;
  for (int64_t t0 = (int64_t)blockIdx.x * step + threadIdx.y; t0 < T;
       t0 += step * gridDim.x) {
    int64_t src[PLANE_ROWS_PER_THREAD];   // first chunk of each source row
#pragma unroll
    for (int k = 0; k < PLANE_ROWS_PER_THREAD; ++k) {
      const int64_t t = t0 + k * ny;
      int64_t row = 0;
      if (t < T) {
        const int32_t i = __ldg(idx + t);
        row = kSmall ? (int64_t)jax_row32(i, (int)R) : jax_row(i, R);
      }
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

// out[b, t, :] = plane[b, jax_row(idx[b, t]), :]: document b's rows
// (each the W chunks of V above).
template <typename V, bool kSmall>
__global__ void __launch_bounds__(PLANE_ROWS_THREADS)
plane_rows_kernel(const V* __restrict__ plane, int64_t B, int64_t R,
                  int64_t W, const int32_t* __restrict__ idx, int64_t T,
                  V* __restrict__ out) {
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y)
    doc_rows<V, kSmall>(plane + b * R * W, R, W, idx + b * T, T,
                        out + b * T * W);
}

__global__ void plane_rows2_kernel(const int64_t* __restrict__ plane_all,
                                   int64_t B, int64_t R, int64_t C,
                                   const int32_t* __restrict__ idx_all,
                                   int64_t T, int64_t* __restrict__ out_all,
                                   int64_t* __restrict__ out2_all,
                                   int hop_col) {
  const int64_t total = T * C;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t* plane = plane_all + b * R * C;
    const int32_t* idx = idx_all + b * T;
    int64_t* out = out_all + b * total;
    int64_t* out2 = out2_all + b * total;
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
}

// gridDim.y: the documents, at most the hardware's 65,535 (the kernels
// loop over the rest)
static unsigned int doc_blocks(int64_t B) {
  return (unsigned int)(B < 65535 ? B : 65535);
}

template <typename V>
static void launch_rows(const RowPlan& p, const void* plane, int64_t B,
                        int64_t R, int64_t C, const void* idx, int64_t T,
                        void* out, cudaStream_t s) {
  const int64_t W = C / (p.vec_bytes / 8);
  const dim3 block(p.threads_per_row, p.rows_per_block);
  const dim3 grid(grid_blocks(T, p.rows_per_block * p.rows_per_thread),
                  doc_blocks(B));
  if (R <= 2147483647LL)
    plane_rows_kernel<V, true><<<grid, block, 0, s>>>(
        (const V*)plane, B, R, W, (const int32_t*)idx, T, (V*)out);
  else
    plane_rows_kernel<V, false><<<grid, block, 0, s>>>(
        (const V*)plane, B, R, W, (const int32_t*)idx, T, (V*)out);
}

// B documents: plane [B, R, C], idx [B, T], out (and out2) [B, T, C].
// out2 == nullptr: one hop (plane_rows); else two hops (plane_rows2).
extern "C" int crdt_plane_rows_batched(const void* plane, int64_t B,
                                       int64_t R, int64_t C, const void* idx,
                                       int64_t T, void* out, void* out2,
                                       int hop_col, void* stream) {
  if (B < 0 || R < 1 || C < 1 || T < 0 ||
      (out2 && (hop_col < 0 || hop_col >= C)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (out2) {
    const dim3 grid(grid_blocks(T * C, PLANE_ROWS2_THREADS), doc_blocks(B));
    plane_rows2_kernel<<<grid, PLANE_ROWS2_THREADS, 0, s>>>(
        (const int64_t*)plane, B, R, C, (const int32_t*)idx, T,
        (int64_t*)out, (int64_t*)out2, hop_col);
    return (int)cudaGetLastError();
  }
  // a document's plane and output rows start 16-byte aligned whenever
  // the first's do and C is even: the plan needs nothing more
  const bool aligned16 = ((uintptr_t)plane % 16 == 0) &&
                         ((uintptr_t)out % 16 == 0);
  const RowPlan p = plane_rows_plan(C, aligned16);
  if (p.vec_bytes == 16)
    launch_rows<longlong2>(p, plane, B, R, C, idx, T, out, s);
  else
    launch_rows<long long>(p, plane, B, R, C, idx, T, out, s);
  return (int)cudaGetLastError();
}

// One document: the batch of one.
extern "C" int crdt_plane_rows(const void* plane, int64_t R, int64_t C,
                               const void* idx, int64_t T, void* out,
                               void* out2, int hop_col, void* stream) {
  return crdt_plane_rows_batched(plane, 1, R, C, idx, T, out, out2, hop_col,
                                 stream);
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
