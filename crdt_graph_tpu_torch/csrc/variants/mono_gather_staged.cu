// Kernel 4 with its monotone window staged in shared memory: the design
// that csrc/mono_gather.cu was measured against (PERF.md, section 6).  The
// package does not build it; it builds and runs in that file's place
// (same entry point, same contract), in a copy of the package that
// `python -m crdt_graph_tpu_torch.bench.kerneltime --roots` times beside
// the checkout (the module's docstring has the commands).
//
// out[v, t] = values[v, rid[t]], int32, with JAX's index rule (a negative
// index wraps once, the rest clamps).  One block of 256 threads takes a
// tile of 2,048 tokens:
//   1. the tile's rid is read with 16-byte loads (4-byte ones over the
//      ragged head and tail of a view at any offset) and its rows are
//      kept in shared memory;
//   2. on the merge's path rid is nondecreasing with steps <= 1, so the
//      tile reads only the columns [row(rid[t0]), row(rid[t_last])] of
//      values, at most 2,048 of them: that window of each value row is
//      copied into shared memory the same way, its loads issued while
//      the tile's rid loads are in flight;
//   3. each output row of the tile is written with 16-byte stores over
//      its aligned body (a row of stride T starts off a 16-byte boundary
//      when T is odd) and 4-byte ones over its head and tail, each
//      thread taking 4 consecutive tokens whose rows it reads from
//      shared memory with two aligned 16-byte loads.
// A token whose row falls outside the window (a step > 1, a decreasing
// run, a wrapped negative index) reads `values` from global memory in the
// same pass: any rid gives values[:, rid] exactly, only slower.  V is a
// template parameter for V = 1..8; a larger V runs the generic
// instantiation, which stages no window (every token reads global
// memory).  Index math inside a row is 32-bit (the entry point refuses R
// or T of 2^31 - 2,048 or more); row bases are 64-bit pointers.
#include <atomic>

#include "common.cuh"

#define MG_THREADS 256
#define MG_TILE 2048                             // tokens a block
#define MG_PER (MG_TILE / 4 / MG_THREADS)        // 16-byte groups a thread
#define MG_ROWS_WORDS (MG_TILE + 8)              // the tile's rows
#define MG_WSPAN (MG_TILE + 4)                   // words of a window row

// Offset in 4-byte words of p above the 16-byte boundary below it.
__device__ __forceinline__ int mis4(const void* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// Block-wide dst[mis4(src) + i] = src[i] for i < n <= MG_TILE: 16-byte
// loads and stores over the aligned body, 4-byte ones over head and tail.
__device__ __forceinline__ void stage_window(const int32_t* __restrict__ src,
                                             int n, int32_t* dst) {
  const int off = mis4(src);
  const int head = min(n, (4 - off) & 3);
  const int nvec = (n - head) >> 2;
  const int tail = head + 4 * nvec;
  const int tid = threadIdx.x;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + off + head);
#pragma unroll
  for (int k = 0; k < MG_PER; ++k) {
    const int j = tid + k * MG_THREADS;
    if (j < nvec) d4[j] = __ldg(s4 + j);
  }
  if (tid < head) dst[off + tid] = __ldg(src + tid);
  if (tid < n - tail) dst[off + tail + tid] = __ldg(src + tail + tid);
}

// Dynamic shared memory: the tile's rows (MG_ROWS_WORDS), then VT window
// rows of MG_WSPAN words.
template <int VT>
__global__ void __launch_bounds__(MG_THREADS)
mono_gather_staged(const int32_t* __restrict__ values, int V, int R,
                   const int32_t* __restrict__ rid, int T,
                   int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_rows = smem;
  int32_t* s_win = smem + MG_ROWS_WORDS;
  const int nv = VT > 0 ? VT : V;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * MG_TILE;
  const int n = min(MG_TILE, T - t0);
  const int32_t* src = rid + t0;

  // 1. the tile's rid into registers (kept as rows in step 2's shadow)
  const int roff = mis4(src);
  const int rhead = min(n, (4 - roff) & 3);
  const int rnvec = (n - rhead) >> 2;
  const int rtail = rhead + 4 * rnvec;
  const int4* r4 = reinterpret_cast<const int4*>(src + rhead);
  int4 q[MG_PER];
#pragma unroll
  for (int k = 0; k < MG_PER; ++k) {
    const int j = tid + k * MG_THREADS;
    if (j < rnvec) q[k] = __ldg(r4 + j);
  }
  const int qh = tid < rhead ? __ldg(src + tid) : 0;
  const int qt = tid < n - rtail ? __ldg(src + rtail + tid) : 0;

  // 2. the window of each value row, loaded while rid is in flight
  const int lo = jax_row32(__ldg(src), R);
  const int hi = jax_row32(__ldg(src + n - 1), R);
  const int width = VT == 0 ? 0 : (hi < lo ? 1 : min(hi - lo + 1, MG_TILE));
#pragma unroll
  for (int v = 0; v < VT; ++v)
    stage_window(values + (int64_t)v * R + lo, width, s_win + v * MG_WSPAN);

  // the rows of the tile's tokens, at rid's offset modulo 16 bytes
  int4* d4 = reinterpret_cast<int4*>(s_rows + roff + rhead);
#pragma unroll
  for (int k = 0; k < MG_PER; ++k) {
    const int j = tid + k * MG_THREADS;
    if (j < rnvec)
      d4[j] = make_int4(jax_row32(q[k].x, R), jax_row32(q[k].y, R),
                        jax_row32(q[k].z, R), jax_row32(q[k].w, R));
  }
  if (tid < rhead) s_rows[roff + tid] = jax_row32(qh, R);
  if (tid < n - rtail) s_rows[roff + rtail + tid] = jax_row32(qt, R);
  __syncthreads();

  // 3. each output row: 16-byte stores over its aligned body
  for (int v = 0; v < nv; ++v) {
    const int32_t* vrow = values + (int64_t)v * R;
    const int32_t* win = s_win + (VT > 0 ? v : 0) * MG_WSPAN + mis4(vrow + lo);
    auto val = [&](int r) -> int32_t {
      const unsigned c = (unsigned)(r - lo);
      return c < (unsigned)width ? win[c] : __ldg(vrow + r);
    };
    int32_t* orow = out + (int64_t)v * T + t0;
    const int ooff = mis4(orow);
    const int head = min(n, (4 - ooff) & 3);
    const int ng = (n - head) >> 2;
    const int tail = head + 4 * ng;
    if (tid < head) orow[tid] = val(s_rows[roff + tid]);
    if (tid < n - tail) orow[tail + tid] = val(s_rows[roff + tail + tid]);
    // group g holds tokens head + 4g .. + 3, whose rows start at
    // s_rows[roff + head + 4g]: sh words past a 16-byte boundary
    const int base = roff + head;
    const int sh = base & 3;
    const int4* s4 = reinterpret_cast<const int4*>(s_rows + (base - sh));
    int4* o4 = reinterpret_cast<int4*>(orow + head);
#pragma unroll
    for (int k = 0; k < MG_PER; ++k) {
      const int g = tid + k * MG_THREADS;
      if (g < ng) {
        const int4 a = s4[g];
        int4 r = a;
        if (sh) {
          const int4 b = s4[g + 1];
          if (sh == 1) r = make_int4(a.y, a.z, a.w, b.x);
          else if (sh == 2) r = make_int4(a.z, a.w, b.x, b.y);
          else r = make_int4(a.w, b.x, b.y, b.z);
        }
        o4[g] = make_int4(val(r.x), val(r.y), val(r.z), val(r.w));
      }
    }
  }
}

template <int VT>
static int launch(const void* values, int V, int R, const void* rid, int T,
                  void* out, cudaStream_t stream) {
  const int smem = (MG_ROWS_WORDS + VT * MG_WSPAN) * (int)sizeof(int32_t);
  // above 48 KB a kernel must be allowed the dynamic shared memory, once
  // on each device
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(mono_gather_staged<VT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit);
  }
  const unsigned blocks = (unsigned)((T + MG_TILE - 1) / MG_TILE);
  mono_gather_staged<VT><<<blocks, MG_THREADS, smem, stream>>>(
      (const int32_t*)values, V, R, (const int32_t*)rid, T, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int crdt_monotone_gather(const void* values, int64_t V, int64_t R,
                                    const void* rid, int64_t T, void* out,
                                    void* stream) {
  if (V < 1 || V > 0x7fffffff || R < 1 || R > 0x7fffffff - MG_TILE ||
      T < 0 || T > 0x7fffffff - MG_TILE)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int v = (int)V, r = (int)R, t = (int)T;
  switch (v) {
    case 1: return launch<1>(values, v, r, rid, t, out, s);
    case 2: return launch<2>(values, v, r, rid, t, out, s);
    case 3: return launch<3>(values, v, r, rid, t, out, s);
    case 4: return launch<4>(values, v, r, rid, t, out, s);
    case 5: return launch<5>(values, v, r, rid, t, out, s);
    case 6: return launch<6>(values, v, r, rid, t, out, s);
    case 7: return launch<7>(values, v, r, rid, t, out, s);
    case 8: return launch<8>(values, v, r, rid, t, out, s);
    default: return launch<0>(values, v, r, rid, t, out, s);
  }
}

// The batched entry point the package binds, for this variant built in
// place of csrc/mono_gather.cu: one launch a document (the variant is
// timed on one document).
extern "C" int crdt_monotone_gather_batched(const void* values, int64_t B,
                                            int64_t V, int64_t R,
                                            const void* rid, int64_t T,
                                            void* out, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  for (int64_t b = 0; b < B; ++b) {
    const int e = crdt_monotone_gather(
        (const int32_t*)values + b * V * R, V, R, (const int32_t*)rid + b * T,
        T, (int32_t*)out + b * V * T, stream);
    if (e) return e;
  }
  return 0;
}
