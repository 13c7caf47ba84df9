// Tour-tail prefix sums: inclusive int32 cumsums of boundary[T] and of
// each row of weights[Kw, M], every lane independent; batched, of each
// document's boundary[b, T] and weights[b, Kw, M] (B boundary lanes and
// B * Kw weight lanes, each restarting at its own first element).
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
// resetting it at each lane's first tile.  GPU blocks run in no order, so
// the carry becomes a single-pass scan with decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), in one launch that reads and writes each element once:
//   - the grid is the flat list of every lane's tiles of 4,096 elements
//     (ceil(T/4096) for the boundary lane, ceil(M/4096) for each weight
//     lane), so no block is launched empty;
//   - a block takes its tile from an atomic counter, not from blockIdx:
//     blocks are not scheduled in order, and a block spinning on a
//     predecessor that never got a slot would hang the card once its
//     successors filled every SM; a counter hands out tiles only to
//     blocks already running;
//   - each warp scans 512 consecutive elements of the tile: four rows of
//     128, each row one 16-byte chunk a lane, so every load and store
//     instruction of a warp covers 512 contiguous bytes (16-byte accesses
//     where the lane's pointer is 16-byte aligned, 4-byte ones where it is
//     not: weight rows of stride M and chunks at odd offsets); a lane
//     scans its chunk, the warp scans the chunk totals by shuffles row by
//     row, and the block scans the warp totals;
//   - the block publishes its tile's aggregate, then its inclusive prefix,
//     in a 64-bit status word (flag in the high half, value in the low);
//   - warp 0 looks back over its predecessors' status words 32 at a time,
//     summing aggregates until it meets an inclusive prefix; the lane's
//     first tile publishes its prefix at once, so no look-back leaves its
//     lane.
// Each 16-byte load of a warp spans 512 contiguous bytes: with 16
// consecutive elements a thread instead, a warp's loads stride 64 bytes and
// the kernel took 0.0146 ms against this layout's 0.0093 ms on an H100
// (PERF.md, section 6).
// The entry point zeroes the counter and the status words on the stream
// before the launch (they live in the caller's scratch), so a call never
// reads a status of an earlier one.  Sums are taken in uint32 so
// wrapping is defined.
#include "common.cuh"

#define SCAN_THREADS 256
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_CHUNKS 4                        // 16-byte chunks a thread
#define SCAN_ITEMS (4 * SCAN_CHUNKS)          // elements a thread
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)  // elements a tile: 4,096
#define WARP_SPAN (32 * SCAN_ITEMS)           // elements a warp

#define ST_AGGREGATE 1ull
#define ST_PREFIX 2ull

struct Lanes {
  const int32_t* b;
  int32_t* ob;
  int64_t T;
  const int32_t* w;
  int32_t* ow;
  int64_t M;
  int64_t nb;       // boundary lanes (the documents), T apart
  int64_t tiles_b;  // tiles of each boundary lane
  int64_t tiles_w;  // tiles of each weight lane
};

__device__ __forceinline__ uint64_t ld_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(uint64_t* p, uint64_t flag,
                                          uint32_t value) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"((flag << 32) | value) : "memory");
}

// Warp 0: the sum of every tile of this lane before tile g (first = the
// lane's first tile), from the status words of its predecessors.
__device__ uint32_t look_back(const uint64_t* status, int64_t g,
                              int64_t first) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  uint32_t excl = 0;
  for (int64_t p = g - 1;; p -= 32) {
    const int64_t q = p - lane;
    uint64_t s;
    for (long spins = 0;; ++spins) {
      // tiles before the lane's first count as a zero prefix: the first
      // tile's own prefix is nearer, so they are never summed
      s = q >= first ? ld_status(status + q) : (ST_PREFIX << 32);
      if (!__any_sync(full, (s >> 32) == 0)) break;
      // a predecessor holds a slot and publishes within microseconds;
      // one silent for 2^22 polls (about a second) is a fault: end the
      // launch with an error rather than hang the card
      if (spins > (1l << 22)) __trap();
      __nanosleep(32);
    }
    const unsigned prefixes = __ballot_sync(full, (s >> 32) == ST_PREFIX);
    // the nearest inclusive prefix ends the walk: sum it and the
    // aggregates of the tiles between it and g
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    uint32_t part = lane <= stop ? (uint32_t)s : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(full, part, d);
    excl += part;
    if (prefixes) return excl;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_lookback(Lanes L, unsigned long long* __restrict__ scratch) {
  __shared__ uint32_t s_warp[SCAN_WARPS];
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_excl;
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch + 1);
  if (threadIdx.x == 0) s_tile = (int64_t)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int64_t g = s_tile;
  const int32_t* in;
  int32_t* out;
  int64_t n, j;
  const int64_t all_b = L.nb * L.tiles_b;
  if (g < all_b) {
    const int64_t q = g / L.tiles_b;
    j = g - q * L.tiles_b;
    in = L.b + q * L.T;
    out = L.ob + q * L.T;
    n = L.T;
  } else {
    const int64_t q = (g - all_b) / L.tiles_w;
    j = g - all_b - q * L.tiles_w;
    in = L.w + q * L.M;
    out = L.ow + q * L.M;
    n = L.M;
  }
  const int64_t base = j * SCAN_TILE;
  const int cnt = (int)(n - base < SCAN_TILE ? n - base : SCAN_TILE);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  in += base;
  out += base;
  // warp-striped: chunk q of this thread holds elements e0(q) .. e0(q)+3,
  // e0(q) = warp * WARP_SPAN + q * 128 + lane * 4, so each 16-byte load
  // of a warp covers 512 contiguous bytes
  const int e0 = warp * WARP_SPAN + lane * 4;
  const bool vin = (((uintptr_t)in) & 15) == 0;
  uint32_t x[SCAN_CHUNKS][4];
#pragma unroll
  for (int q = 0; q < SCAN_CHUNKS; ++q) {
    const int e = e0 + q * 128;
    if (vin && e + 4 <= cnt) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(in + e));
      x[q][0] = (uint32_t)v.x;
      x[q][1] = (uint32_t)v.y;
      x[q][2] = (uint32_t)v.z;
      x[q][3] = (uint32_t)v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[q][k] = e + k < cnt ? (uint32_t)__ldg(in + e + k) : 0u;
    }
  }
  uint32_t run = 0;  // the warp's sum over its chunks so far
#pragma unroll
  for (int q = 0; q < SCAN_CHUNKS; ++q) {
    x[q][1] += x[q][0];
    x[q][2] += x[q][1];
    x[q][3] += x[q][2];
    const uint32_t t = x[q][3];
    uint32_t incl = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(full, incl, d);
      if (lane >= d) incl += y;
    }
    const uint32_t pre = run + incl - t;
#pragma unroll
    for (int k = 0; k < 4; ++k) x[q][k] += pre;
    run += __shfl_sync(full, incl, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  if (warp == 0) {
    const uint32_t wv = lane < SCAN_WARPS ? s_warp[lane] : 0u;
    uint32_t wi = wv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(full, wi, d);
      if (lane >= d) wi += y;
    }
    const uint32_t agg = __shfl_sync(full, wi, SCAN_WARPS - 1);
    if (lane < SCAN_WARPS) s_warp[lane] = wi - wv;  // exclusive, per warp
    uint32_t excl = 0;
    if (j == 0) {
      if (lane == 0) st_status(status + g, ST_PREFIX, agg);
    } else {
      if (lane == 0) st_status(status + g, ST_AGGREGATE, agg);
      excl = look_back(status, g, g - j);
      if (lane == 0) st_status(status + g, ST_PREFIX, excl + agg);
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const uint32_t off = s_excl + s_warp[warp];
  const bool vout = (((uintptr_t)out) & 15) == 0;
#pragma unroll
  for (int q = 0; q < SCAN_CHUNKS; ++q) {
    const int e = e0 + q * 128;
    if (vout && e + 4 <= cnt) {
      *reinterpret_cast<int4*>(out + e) =
          make_int4((int)(x[q][0] + off), (int)(x[q][1] + off),
                    (int)(x[q][2] + off), (int)(x[q][3] + off));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e + k < cnt) out[e + k] = (int32_t)(x[q][k] + off);
    }
  }
}

// B documents: boundary and out_b [B, T], weights and out_w [B, Kw, M]
// (B * Kw weight lanes of M).  scratch: at least 1 + B * ceil(T/4096) +
// B * Kw * ceil(M/4096) 8-byte words (the tile counter, then one status
// word a tile); zeroed here.
extern "C" int crdt_prefix_sums_batched(const void* boundary, void* out_b,
                                        int64_t B, int64_t T,
                                        const void* weights, void* out_w,
                                        int64_t Kw, int64_t M, void* scratch,
                                        int64_t scratch_len, void* stream) {
  if (B < 0 || T < 0 || M < 0 || Kw < 0) return (int)cudaErrorInvalidValue;
  const int64_t lim = 0x7fffffff;
  const int64_t tiles_b = (T + SCAN_TILE - 1) / SCAN_TILE;
  const int64_t tiles_w = (M + SCAN_TILE - 1) / SCAN_TILE;
  if (B > 0 && tiles_b > lim / B) return (int)cudaErrorInvalidValue;
  const int64_t all_b = B * tiles_b;
  const int64_t lanes_w = B * Kw;
  if (Kw > 0 && B > lim / Kw) return (int)cudaErrorInvalidValue;
  if (tiles_w > 0 && lanes_w > (lim - all_b) / tiles_w)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = all_b + lanes_w * tiles_w;
  if (tiles == 0) return (int)cudaSuccess;
  if (scratch_len < 1 + tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(1 + tiles) * 8, s);
  if (e != cudaSuccess) return (int)e;
  Lanes L{(const int32_t*)boundary, (int32_t*)out_b, T,
          (const int32_t*)weights, (int32_t*)out_w, M, B, tiles_b, tiles_w};
  scan_lookback<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(
      L, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

// One document: the batch of one.  scratch: at least 1 + ceil(T/4096) +
// Kw * ceil(M/4096) 8-byte words.
extern "C" int crdt_prefix_sums(const void* boundary, void* out_b, int64_t T,
                                const void* weights, void* out_w, int64_t Kw,
                                int64_t M, void* scratch, int64_t scratch_len,
                                void* stream) {
  return crdt_prefix_sums_batched(boundary, out_b, 1, T, weights, out_w, Kw,
                                  M, scratch, scratch_len, stream);
}
