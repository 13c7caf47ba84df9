// Tour-tail prefix sums: inclusive int32 cumsums of boundary[T] and of
// each row of weights[Kw, M], every lane independent.
//
// Replaces the Pallas kernel of crdt_graph_tpu/ops/tour_scan.py
// (prefix_sums -> _pallas_call -> _kernel).  Semantics are the
// reference's _lax_prefix exactly (lax.cumsum per lane, int32, wrapping);
// unlike the TPU kernel, inputs need not be 0/1 and any Kw and T work.
//
// What bounds it: bytes.  Each element is read once and written once
// (8 B); at the merge's main-path shape (T = 2M, Kw = 1, M = 1,000,002)
// that is ~24 MB, ~7 us at 3.35 TB/s.  Per element there is one add.
//
// Design for Hopper: the TPU kernel swept one concatenated stream on a
// sequential grid, carrying the running sum in SMEM from tile to tile and
// resetting it at each lane's first tile, with the in-tile prefix as a
// triangular f32 MXU product.  GPU blocks run in no order, so the carry
// becomes a three-phase scan over a grid with one row per lane:
//   1. each block scans a tile of 4096 elements in shared memory (8
//      consecutive elements per thread, then warp shuffles) and writes its
//      tile total;
//   2. one block per lane scans that lane's tile totals into exclusive
//      tile offsets;
//   3. each block adds its tile offset to its outputs.
// This reads the outputs twice more than a single-pass scan would; a
// decoupled look-back scan that folds phases 2-3 into phase 1 is later
// work.  Sums are taken in uint32 so wrapping is defined.
#include "common.cuh"

#define SCAN_THREADS 512
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)

struct Lanes {
  const int32_t* b;
  int32_t* ob;
  int64_t T;
  const int32_t* w;
  int32_t* ow;
  int64_t M;
};

__device__ __forceinline__ int64_t lane_ptrs(const Lanes& L, int lane,
                                             const int32_t** in,
                                             int32_t** out) {
  if (lane == 0) {
    *in = L.b;
    *out = L.ob;
    return L.T;
  }
  *in = L.w + (int64_t)(lane - 1) * L.M;
  *out = L.ow + (int64_t)(lane - 1) * L.M;
  return L.M;
}

// Block-wide exclusive scan of one value per thread (blockDim.x a
// multiple of 32, at most 1024).  `ws` holds 33 words of shared memory.
// Every thread of the block must call it.
__device__ uint32_t block_exclusive_scan(uint32_t x, uint32_t* ws,
                                         uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < nwarps ? ws[lane] : 0u;
    uint32_t vi = v;
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t y = __shfl_up_sync(0xffffffffu, vi, d);
      if (lane >= d) vi += y;
    }
    if (lane < nwarps) ws[lane] = vi - v;
    if (lane == 31) ws[32] = vi;
  }
  __syncthreads();
  *total = ws[32];
  const uint32_t r = ws[warp] + incl - x;
  __syncthreads();
  return r;
}

// Phase 1: per-tile inclusive scan; grid (tiles, lanes).
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(Lanes L, uint32_t* __restrict__ tile_sums, int64_t nblk) {
  __shared__ uint32_t s[SCAN_TILE];
  __shared__ uint32_t ws[33];
  const int32_t* in;
  int32_t* out;
  const int64_t n = lane_ptrs(L, blockIdx.y, &in, &out);
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  if (base >= n) return;  // uniform over the block
  const int tid = threadIdx.x;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCAN_THREADS + tid;
    s[i] = base + i < n ? (uint32_t)__ldg(in + base + i) : 0u;
  }
  __syncthreads();
  uint32_t loc[SCAN_ITEMS];
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    acc += s[tid * SCAN_ITEMS + j];
    loc[j] = acc;
  }
  uint32_t total;
  const uint32_t pre = block_exclusive_scan(acc, ws, &total);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) s[tid * SCAN_ITEMS + j] = pre + loc[j];
  __syncthreads();
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCAN_THREADS + tid;
    if (base + i < n) out[base + i] = (int32_t)s[i];
  }
  if (tid == 0) tile_sums[(int64_t)blockIdx.y * nblk + blockIdx.x] = total;
}

// Phase 2: exclusive scan of one lane's tile totals; grid (lanes).
__global__ void __launch_bounds__(1024)
scan_tile_sums(Lanes L, uint32_t* __restrict__ tile_sums, int64_t nblk) {
  __shared__ uint32_t ws[33];
  const int32_t* in;
  int32_t* out;
  const int64_t n = lane_ptrs(L, blockIdx.x, &in, &out);
  const int64_t nb = (n + SCAN_TILE - 1) / SCAN_TILE;
  uint32_t* p = tile_sums + (int64_t)blockIdx.x * nblk;
  uint32_t carry = 0;
  for (int64_t off = 0; off < nb; off += blockDim.x) {
    const int64_t i = off + threadIdx.x;
    const uint32_t x = i < nb ? p[i] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive_scan(x, ws, &total);
    if (i < nb) p[i] = carry + ex;
    carry += total;
  }
}

// Phase 3: add each tile's offset; grid (tiles, lanes).
__global__ void __launch_bounds__(SCAN_THREADS)
add_tile_offsets(Lanes L, const uint32_t* __restrict__ tile_sums,
                 int64_t nblk) {
  const int32_t* in;
  int32_t* out;
  const int64_t n = lane_ptrs(L, blockIdx.y, &in, &out);
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  if (blockIdx.x == 0 || base >= n) return;
  const uint32_t off = tile_sums[(int64_t)blockIdx.y * nblk + blockIdx.x];
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int64_t i = base + k * SCAN_THREADS + threadIdx.x;
    if (i < n) out[i] = (int32_t)((uint32_t)out[i] + off);
  }
}

// scratch: at least (1 + Kw) * ceil(max(T, M) / 4096) int32 words.
extern "C" int crdt_prefix_sums(const void* boundary, void* out_b, int64_t T,
                                const void* weights, void* out_w, int64_t Kw,
                                int64_t M, void* scratch, int64_t scratch_len,
                                void* stream) {
  if (T < 0 || M < 0 || Kw < 0 || 1 + Kw > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t longest = T > M ? T : M;
  const int64_t nblk = (longest + SCAN_TILE - 1) / SCAN_TILE;
  const int lanes = (int)(1 + Kw);
  if (nblk == 0) return (int)cudaGetLastError();
  if (scratch_len < lanes * nblk || nblk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Lanes L{(const int32_t*)boundary, (int32_t*)out_b, T,
          (const int32_t*)weights, (int32_t*)out_w, M};
  uint32_t* sums = (uint32_t*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned int)nblk, lanes);
  scan_tiles<<<grid, SCAN_THREADS, 0, s>>>(L, sums, nblk);
  scan_tile_sums<<<lanes, 1024, 0, s>>>(L, sums, nblk);
  add_tile_offsets<<<grid, SCAN_THREADS, 0, s>>>(L, sums, nblk);
  return (int)cudaGetLastError();
}
