// Ring carry exchange of the ops-axis sharded merge: shard i receives the
// exclusive combine of the carry vectors of every lower shard,
//   dst[i][l] = combine_{j < i} src[j][l],   shard 0 the identity.
//
// Replaces the Pallas kernel of crdt_graph_tpu/ops/tour_scan.py
// (ring_exclusive_pallas -> _ring_carry_kernel).  Semantics are the
// reference's ring_exclusive (the lax.ppermute twin, add and max):
// "add" wraps like int32 (the sums are taken in uint32); "max" starts from
// 0, the zero-fill a ppermute delivers to a device with no sender, so the
// result is max(0, max_{j<i} src[j][l]) -- callers bias their values to
// >= 1, and negative totals clamp to 0 exactly as in the reference.
//
// What bounds it: launch latency.  A merge exchanges k <= 8 vectors of
// L <= 5 lanes (2 + Kw for the tour prefix, 1 for a chunked cumsum or
// cummax): a few hundred bytes, far below a microsecond of memory time.
//
// Design for Hopper: the TPU kernel relayed each device's vector k-1 hops
// around the ring with make_async_remote_copy, because a TPU core can only
// DMA to a neighbour.  Here every shard's buffer is a plain device
// address (unified virtual addressing), so one launch reads them all: the
// k source and k destination pointers ride by value in a struct (at most
// RING_MAX_SHARDS of each), block (i, y) writes lanes of shard i, and each
// thread folds the i lower carries of its lane in order.  The same kernel
// serves k logical shards on one card and shards on several cards of one
// host, once crdt_enable_peer_access has opened the launching card's
// context to the others (over NVLink).
#include "common.cuh"

#define RING_MAX_SHARDS 64
#define RING_THREADS 128

struct RingPtrs {
  const int32_t* src[RING_MAX_SHARDS];
  int32_t* dst[RING_MAX_SHARDS];
};

__global__ void __launch_bounds__(RING_THREADS)
ring_exclusive_kernel(RingPtrs p, int64_t L, int op_max) {
  const int i = blockIdx.x;
  for (int64_t l = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; l < L;
       l += (int64_t)gridDim.y * blockDim.x) {
    if (op_max) {
      int32_t acc = 0;
      for (int j = 0; j < i; ++j) acc = max(acc, p.src[j][l]);
      p.dst[i][l] = acc;
    } else {
      uint32_t acc = 0u;
      for (int j = 0; j < i; ++j) acc += (uint32_t)p.src[j][l];
      p.dst[i][l] = (int32_t)acc;
    }
  }
}

// src, dst: host arrays of k device pointers (each an int32[L] buffer).
// op: 0 add, 1 max.  Launches on `stream`, whose card must reach every
// buffer.
extern "C" int crdt_ring_exclusive(const void* const* src, void* const* dst,
                                   int k, int64_t L, int op, void* stream) {
  if (k < 0 || k > RING_MAX_SHARDS || L < 0 || (op != 0 && op != 1))
    return (int)cudaErrorInvalidValue;
  if (k == 0 || L == 0) return (int)cudaGetLastError();
  RingPtrs p;
  for (int i = 0; i < k; ++i) {
    p.src[i] = (const int32_t*)src[i];
    p.dst[i] = (int32_t*)dst[i];
  }
  int64_t ly = (L + RING_THREADS - 1) / RING_THREADS;
  if (ly > 65535) ly = 65535;
  const dim3 grid((unsigned int)k, (unsigned int)ly);
  ring_exclusive_kernel<<<grid, RING_THREADS, 0, (cudaStream_t)stream>>>(
      p, L, op);
  return (int)cudaGetLastError();
}

// Let kernels running on `device` read and write the memory of `peer`.
// Already-enabled access counts as success; a pair without a peer path
// returns cudaErrorPeerAccessUnsupported.
extern "C" int crdt_enable_peer_access(int device, int peer) {
  if (device == peer) return (int)cudaSuccess;
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}
