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
// What bounds it: bytes.  Per output row it reads one index (4 B) and one
// or two random plane rows (C * 8 B each) and writes one or two rows; at
// the merge's main-path shape (C = 6, T = M = 1,000,002) the two-hop
// sweep moves ~196 MB, ~58 us at 3.35 TB/s.  There is no arithmetic.
//
// Design for Hopper: the TPU kernel staged a bounded window of the plane
// in VMEM and gathered through an exact f32 one-hot MXU product on 16-bit
// limbs, with span and hop-locality checks that sent other inputs to a
// fallback.  Hopper loads int64 from any address, so none of that
// survives: a group of C consecutive threads serves one output row, one
// column each -- the index and the hop are read once per thread through
// the read-only path (the row's other threads hit the same L1 line), the
// row's columns are read from adjacent addresses, and the stores of
// neighbouring threads are contiguous.  Every index works; there is no
// fallback.  Staging rows through shared memory is later work.
#include "common.cuh"

template <bool kHop>
__global__ void plane_rows_kernel(const int64_t* __restrict__ plane,
                                  int64_t R, int64_t C,
                                  const int32_t* __restrict__ idx, int64_t T,
                                  int64_t* __restrict__ out,
                                  int64_t* __restrict__ out2, int hop_col) {
  const int64_t total = T * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t t = e / C;
    const int64_t c = e - t * C;
    const int64_t* row = plane + jax_row((int64_t)__ldg(idx + t), R) * C;
    out[e] = ld_i64(row + c);
    if (kHop) {
      const int64_t hop = ld_i64(row + hop_col);
      int64_t v = 0;
      if (hop >= 0) v = ld_i64(plane + (hop < R ? hop : R - 1) * C + c);
      out2[e] = v;
    }
  }
}

// out2 == nullptr: one hop (plane_rows); else two hops (plane_rows2).
extern "C" int crdt_plane_rows(const void* plane, int64_t R, int64_t C,
                               const void* idx, int64_t T, void* out,
                               void* out2, int hop_col, void* stream) {
  if (R < 1 || C < 1 || T < 0 || (out2 && (hop_col < 0 || hop_col >= C)))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned int blocks = grid_blocks(T * C, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out2)
    plane_rows_kernel<true><<<blocks, threads, 0, s>>>(
        (const int64_t*)plane, R, C, (const int32_t*)idx, T,
        (int64_t*)out, (int64_t*)out2, hop_col);
  else
    plane_rows_kernel<false><<<blocks, threads, 0, s>>>(
        (const int64_t*)plane, R, C, (const int32_t*)idx, T,
        (int64_t*)out, nullptr, 0);
  return (int)cudaGetLastError();
}
