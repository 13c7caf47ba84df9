// Run-to-token rank expansion: out[v, t] = values[v, rid[t]].
//
// Replaces the Pallas kernel of crdt_graph_tpu/ops/mono_gather.py
// (monotone_gather -> _pallas_call -> _kernel).  Semantics are the
// reference's _lax_gather (values[:, rid]) exactly, JAX's index rule
// included (a negative index wraps once, the rest clamps).
//
// What bounds it: bytes.  It reads rid (4 B a token) and the value plane
// (V * R * 4 B, small on the compact run paths) and writes V * 4 B a
// token; at the merge's main-path shape (V = 4, T = M = 1,000,002) that is
// ~20 MB, ~6 us at 3.35 TB/s.
//
// Design for Hopper: the TPU kernel DMA'd a bounded window of `values`
// into VMEM per tile (rid is nondecreasing with steps <= 1) and gathered
// with an exact f32 one-hot product, refusing values >= 2^24.  Here one
// thread serves one token: it reads rid once and the V values of its run,
// which neighbouring tokens share (same or adjacent run), so the reads
// come from L1/L2; the V stores of a warp are contiguous rows of the
// output.  Any rid and any int32 value work.  Staging
// values[:, rid[t0] : rid[t0] + blockDim + 1] in shared memory -- the
// monotone trick -- is later work.
#include "common.cuh"

__global__ void monotone_gather_kernel(const int32_t* __restrict__ values,
                                       int64_t V, int64_t R,
                                       const int32_t* __restrict__ rid,
                                       int64_t T, int32_t* __restrict__ out) {
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < T;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = jax_row((int64_t)__ldg(rid + t), R);
    for (int64_t v = 0; v < V; ++v) out[v * T + t] = __ldg(values + v * R + r);
  }
}

extern "C" int crdt_monotone_gather(const void* values, int64_t V, int64_t R,
                                    const void* rid, int64_t T, void* out,
                                    void* stream) {
  if (V < 1 || R < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  monotone_gather_kernel<<<grid_blocks(T, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)values, V, R, (const int32_t*)rid, T, (int32_t*)out);
  return (int)cudaGetLastError();
}
