// Run-to-token rank expansion: out[v, t] = values[v, rid[t]]; batched,
// out[b, v, t] = values[b, v, rid[b, t]] (blockIdx.y walks the documents,
// and each index is clamped against the document's own R).
//
// Replaces the Pallas kernel of crdt_graph_tpu/ops/mono_gather.py
// (monotone_gather -> _pallas_call -> _kernel).  Semantics are the
// reference's _lax_gather (values[:, rid]) exactly, JAX's index rule
// included (a negative index wraps once, the rest clamps).
//
// What bounds it: bytes.  It reads rid (4 B a token) and the value plane
// (V * R * 4 B, small on the compact run paths) and writes V * 4 B a
// token; at the merge's main-path shape (V = 4, R = 4096, T = M =
// 1,000,002) that is ~20 MB, ~6 us at 3.35 TB/s.  Nothing in it is
// compute.
//
// Design for Hopper: the TPU kernel DMA'd a bounded window of `values`
// into VMEM per tile (rid is nondecreasing with steps <= 1) and gathered
// with an exact f32 one-hot product, refusing values >= 2^24.  On the card
// the window needs no staging: neighbouring tokens read the same or the
// next column, so a warp's reads of a value row fall on one or two cache
// lines that L1 and L2 already hold, and every byte of DRAM traffic left
// is rid in and the output rows out.  Staging the window in shared memory,
// with 16-byte loads and stores (variants/mono_gather_staged.cu), was
// built and measured on an H100 (PERF.md, section 6): it adds a barrier a
// tile and moves no fewer bytes, and took 0.0075 ms against this design's
// 0.0063 at V = 4 and 0.0149 against 0.0110 at V = 7.  So one block of
// 256 threads takes 1,024 tokens, 4 a thread striped by the block width:
// each thread loads its 4 rid values at once (coalesced 4-byte loads, 4
// in flight), then for each value row reads the 4 values and writes them
// (each warp store is 128 contiguous bytes, whatever the alignment of T
// or of the views).  Any rid and any int32
// value work.  V is a template parameter for V = 1..8 (the merge uses 4
// and 7); a larger V takes the generic instantiation.  Index math inside
// a row is 32-bit (the entry point refuses R or T of 2^31 - 1024 or
// more); row bases are 64-bit pointers.
#include "common.cuh"

#define MG_THREADS 256
#define MG_ITEMS 4                          // tokens a thread
#define MG_TILE (MG_THREADS * MG_ITEMS)     // tokens a block

template <int VT>
__global__ void __launch_bounds__(MG_THREADS)
mono_gather_kernel(const int32_t* __restrict__ values_all, int64_t B, int V,
                   int R, const int32_t* __restrict__ rid_all, int T,
                   int32_t* __restrict__ out_all) {
  const int nv = VT > 0 ? VT : V;
  const int t0 = blockIdx.x * MG_TILE + threadIdx.x;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const int32_t* values = values_all + b * V * (int64_t)R;
    const int32_t* rid = rid_all + b * T;
    int32_t* out = out_all + b * V * (int64_t)T;
    int r[MG_ITEMS];
#pragma unroll
    for (int k = 0; k < MG_ITEMS; ++k) {
      const int t = t0 + k * MG_THREADS;
      r[k] = t < T ? jax_row32(__ldg(rid + t), R) : 0;
    }
    // nv is a constant for VT > 0: the row loop unrolls
    for (int v = 0; v < nv; ++v) {
      const int32_t* vrow = values + (int64_t)v * R;
      int32_t* orow = out + (int64_t)v * T;
#pragma unroll
      for (int k = 0; k < MG_ITEMS; ++k) {
        const int t = t0 + k * MG_THREADS;
        if (t < T) orow[t] = __ldg(vrow + r[k]);
      }
    }
  }
}

template <int VT>
static int launch(const void* values, int64_t B, int V, int R,
                  const void* rid, int T, void* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((T + MG_TILE - 1) / MG_TILE),
                  (unsigned)(B < 65535 ? B : 65535));
  mono_gather_kernel<VT><<<grid, MG_THREADS, 0, stream>>>(
      (const int32_t*)values, B, V, R, (const int32_t*)rid, T,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// B documents: values [B, V, R], rid [B, T], out [B, V, T].
extern "C" int crdt_monotone_gather_batched(const void* values, int64_t B,
                                            int64_t V, int64_t R,
                                            const void* rid, int64_t T,
                                            void* out, void* stream) {
  if (B < 0 || V < 1 || V > 0x7fffffff || R < 1 ||
      R > 0x7fffffff - MG_TILE || T < 0 || T > 0x7fffffff - MG_TILE)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int v = (int)V, r = (int)R, t = (int)T;
  switch (v) {
    case 1: return launch<1>(values, B, v, r, rid, t, out, s);
    case 2: return launch<2>(values, B, v, r, rid, t, out, s);
    case 3: return launch<3>(values, B, v, r, rid, t, out, s);
    case 4: return launch<4>(values, B, v, r, rid, t, out, s);
    case 5: return launch<5>(values, B, v, r, rid, t, out, s);
    case 6: return launch<6>(values, B, v, r, rid, t, out, s);
    case 7: return launch<7>(values, B, v, r, rid, t, out, s);
    case 8: return launch<8>(values, B, v, r, rid, t, out, s);
    default: return launch<0>(values, B, v, r, rid, t, out, s);
  }
}

// One document: the batch of one.
extern "C" int crdt_monotone_gather(const void* values, int64_t V, int64_t R,
                                    const void* rid, int64_t T, void* out,
                                    void* stream) {
  return crdt_monotone_gather_batched(values, 1, V, R, rid, T, out, stream);
}
