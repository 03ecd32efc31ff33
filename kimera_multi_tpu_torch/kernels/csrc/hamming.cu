// Hamming top-2 searches: per candidate pair (K1) and DB-wide (K2).
//
// ---- K1, pair top-2 --------------------------------------------------------
//
// Replaces the Pallas kernel `_pair_top2_kernel` (wrapper `_pair_top2`) of
// kimera_multi_tpu/kernels/hamming.py: for every query descriptor of a
// candidate pair, the best and second-best Hamming distance and the best
// index over the pair's valid target descriptors. The (Kq, Kt) distance
// matrix never exists in memory.
//
// The TPU kernel unpacked the 256-bit descriptors to {0,1} bf16 matrices and
// took |a|+|b|-2ab on the matrix unit. Here a descriptor is 8 words of 32
// bits and a distance is 8 XOR + POPC: exact, no unpacking, no padding.
//
// Bound on an H100: the traffic is tiny (each descriptor read once: 2*K*32
// bytes per pair, 3*Kq*4 bytes written), the work is Kq*Kt*8 word pairs per
// pair, each an XOR, a POPC and an add on the integer pipes. The kernel is
// bound by integer instruction issue, not by bytes. What the design does
// about it: the pair's targets are staged once per block in shared memory
// as 16-byte vectors, every thread of a warp reads the same target
// (a broadcast, no bank conflicts), and a query's 8 words stay in registers
// for the whole scan, so the inner loop is 2 shared loads per 24 integer
// instructions.
//
// Ties: distances are small integers and tie often. The comparison is a
// strict `<` while targets are scanned in ascending order, so the lowest
// index wins, as argmin does. An invalid target counts as distance 512
// (beyond any real one); with no valid target the result is (512, 512, 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // queries per block
constexpr int kTile = 512;      // targets staged per pass (16 KB)
constexpr int kNoMatch = 512;

__global__ void __launch_bounds__(kThreads)
pair_top2_kernel(const uint4* __restrict__ dq,       // (C, Kq, 2) uint4
                 const uint4* __restrict__ dt,       // (C, Kt, 2) uint4
                 const uint8_t* __restrict__ valid_t,  // (C, Kt)
                 int* __restrict__ d1_out, int* __restrict__ d2_out,
                 int* __restrict__ i1_out, int Kq, int Kt) {
  __shared__ uint4 s_t[kTile * 2];
  __shared__ int s_valid[kTile];

  const int c = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < Kq;

  uint4 qa = make_uint4(0, 0, 0, 0), qb = qa;
  if (active) {
    const uint4* src = dq + ((size_t)c * Kq + q) * 2;
    qa = src[0];
    qb = src[1];
  }
  int d1 = kNoMatch, d2 = kNoMatch, i1 = 0;

  const uint4* tsrc = dt + (size_t)c * Kt * 2;
  const uint8_t* vsrc = valid_t + (size_t)c * Kt;
  for (int t0 = 0; t0 < Kt; t0 += kTile) {
    const int nt = min(kTile, Kt - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * 2; i += kThreads)
      s_t[i] = tsrc[(size_t)t0 * 2 + i];
    for (int i = threadIdx.x; i < nt; i += kThreads)
      s_valid[i] = vsrc[t0 + i];
    __syncthreads();
    if (active) {
      for (int t = 0; t < nt; ++t) {
        const uint4 a = s_t[2 * t], b = s_t[2 * t + 1];
        int d = __popc(qa.x ^ a.x) + __popc(qa.y ^ a.y) +
                __popc(qa.z ^ a.z) + __popc(qa.w ^ a.w) +
                __popc(qb.x ^ b.x) + __popc(qb.y ^ b.y) +
                __popc(qb.z ^ b.z) + __popc(qb.w ^ b.w);
        d = s_valid[t] ? d : kNoMatch;
        if (d < d1) {
          d2 = d1;
          d1 = d;
          i1 = t0 + t;
        } else if (d < d2) {
          d2 = d;
        }
      }
    }
  }
  if (active) {
    const size_t o = (size_t)c * Kq + q;
    d1_out[o] = d1;
    d2_out[o] = d2;
    i1_out[o] = i1;
  }
}

}  // namespace

// desc_q (C, Kq, 32) u8, desc_t (C, Kt, 32) u8 (both 16-byte aligned),
// valid_t (C, Kt) u8/bool -> d1, d2, i1 (C, Kq) i32.
extern "C" int kmt_pair_top2(const void* desc_q, const void* desc_t,
                             const void* valid_t, void* d1, void* d2,
                             void* i1, int C, int Kq, int Kt, void* stream) {
  if (C <= 0 || Kq <= 0) return (int)cudaGetLastError();
  dim3 grid((Kq + kThreads - 1) / kThreads, C);
  pair_top2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)desc_q, (const uint4*)desc_t, (const uint8_t*)valid_t,
      (int*)d1, (int*)d2, (int*)i1, Kq, Kt);
  return (int)cudaGetLastError();
}


// ---- K2, DB-wide top-2 -----------------------------------------------------
//
// Replaces the Pallas kernel `_hamming_top2_kernel` (wrapper
// `hamming_top2_pallas`) of kimera_multi_tpu/kernels/hamming.py: for every
// query row of {0,1} bf16 bits (Kq, 256), the least and second-least Hamming
// distance to the rows of a large database (Kt, 256) and the first index of
// the least. The TPU kernel took |a|+|b|-2ab on the matrix unit tile by tile
// and carried a running top-2 across the sequential target grid axis.
//
// Here a row is packed to 8 words of 32 bits while it is staged in shared
// memory (a warp reads the row's 512 bytes, 16 per lane, and eight
// __ballot_sync calls turn the lanes' "!= 0" tests into the 8 words; the bit
// order inside a word is the same for queries and targets, and a distance
// does not depend on it), and a distance is 8 XOR + POPC + ADD.
//
// Bound on an H100: the database is read once (Kt * 512 bytes: 2.2 GB at
// Kt = 4.3 M, 0.66 ms at 3.35 TB/s); on this route the work is Kq * Kt * 8
// POPC, at 16 per clock and SM (CUDA C++ Programming Guide, compute
// capability 9.0) 5.8 ms for Kq = 704 at that Kt. The integer tensor cores
// could do the same product as an int8 matrix product in 0.8 ms; that is a
// later redesign. What this design does about its own bound: each thread
// keeps 4 queries' 8 words in registers (512 queries per block), so one
// staged and packed target row serves 512 queries; every thread of a warp
// reads the same target words (a shared-memory broadcast).
//
// The grid's x axis is the query blocks, its y axis contiguous splits of the
// target axis, so the card fills even for a few hundred queries. Each split
// writes a partial (d1, d2, i1); a second kernel merges the splits in split
// order. Within a split targets are scanned in ascending order with a strict
// `<`, and the merge replaces i1 only on a strict `<` too, so i1 is the first
// index of the least distance; d2 keeps multiplicity (d2 == d1 when the least
// occurs twice), as the JAX merge min(max(od1, nd1), min(od2, nd2)) gives.

namespace {

constexpr int kT2Threads = 128;
constexpr int kT2Qpt = 4;                          // queries per thread
constexpr int kT2Queries = kT2Threads * kT2Qpt;    // queries per block
constexpr int kT2Tile = 256;                       // target rows per pass
constexpr int kT2None = 0x3fffffff;                // no target seen

// One row of 256 bf16 bits, lane l holding elements 8l .. 8l+7 in `v`, to
// 8 words (every lane gets all 8).
__device__ __forceinline__ void pack_row(const uint4 v, uint32_t w[8]) {
  const uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[2 * j] = __ballot_sync(0xffffffffu, (h[j] & 0x7fffu) != 0);
    w[2 * j + 1] = __ballot_sync(0xffffffffu, (h[j] & 0x7fff0000u) != 0);
  }
}

// Stage rows [0, n) of `src` (rows of 32 uint4) packed into dst[2 r], dst[2
// r + 1]; warp w takes rows 4 at a time, all four loads issued first.
__device__ __forceinline__ void stage_rows(const uint4* __restrict__ src,
                                           int n, uint4* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kT2Threads / 32;
  for (int r0 = warp * 4; r0 < n; r0 += kWarps * 4) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = r0 + u < n ? src[(size_t)(r0 + u) * 32 + lane]
                        : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t w[8];
      pack_row(v[u], w);
      if (r0 + u < n && lane < 2)
        dst[2 * (r0 + u) + lane] =
            lane == 0 ? make_uint4(w[0], w[1], w[2], w[3])
                      : make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

__global__ void __launch_bounds__(kT2Threads)
hamming_top2_kernel(const uint4* __restrict__ bq,   // (Kq, 32) uint4
                    const uint4* __restrict__ bt,   // (Kt, 32) uint4
                    int* __restrict__ part,         // (3, S, Kq)
                    int Kq, int Kt, int rows_per_split) {
  __shared__ uint4 s_q[kT2Queries * 2];
  __shared__ uint4 s_t[kT2Tile * 2];

  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kT2Queries;
  const int split = blockIdx.y, S = gridDim.y;
  const int lo = split * rows_per_split;
  const int hi = min(Kt, lo + rows_per_split);

  stage_rows(bq + (size_t)q0 * 32, min(kT2Queries, Kq - q0), s_q);
  __syncthreads();
  uint4 qa[kT2Qpt], qb[kT2Qpt];
  int d1[kT2Qpt], d2[kT2Qpt], i1[kT2Qpt];
  bool act[kT2Qpt];  // warp-uniform: the warp holds a real query
#pragma unroll
  for (int j = 0; j < kT2Qpt; ++j) {
    const int r = j * kT2Threads + threadIdx.x;
    qa[j] = s_q[2 * r];
    qb[j] = s_q[2 * r + 1];
    d1[j] = kT2None;
    d2[j] = kT2None;
    i1[j] = -1;
    act[j] = q0 + j * kT2Threads + warp * 32 < Kq;
  }

  for (int t0 = lo; t0 < hi; t0 += kT2Tile) {
    const int nt = min(kT2Tile, hi - t0);
    __syncthreads();
    stage_rows(bt + (size_t)t0 * 32, nt, s_t);
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const uint4 a = s_t[2 * t], b = s_t[2 * t + 1];
#pragma unroll
      for (int j = 0; j < kT2Qpt; ++j) {
        if (!act[j]) continue;
        const int d = __popc(qa[j].x ^ a.x) + __popc(qa[j].y ^ a.y) +
                      __popc(qa[j].z ^ a.z) + __popc(qa[j].w ^ a.w) +
                      __popc(qb[j].x ^ b.x) + __popc(qb[j].y ^ b.y) +
                      __popc(qb[j].z ^ b.z) + __popc(qb[j].w ^ b.w);
        if (d < d1[j]) {
          d2[j] = d1[j];
          d1[j] = d;
          i1[j] = t0 + t;
        } else if (d < d2[j]) {
          d2[j] = d;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kT2Qpt; ++j) {
    const int q = q0 + j * kT2Threads + threadIdx.x;
    if (q < Kq) {
      part[((size_t)0 * S + split) * Kq + q] = d1[j];
      part[((size_t)1 * S + split) * Kq + q] = d2[j];
      part[((size_t)2 * S + split) * Kq + q] = i1[j];
    }
  }
}

__global__ void hamming_top2_merge_kernel(const int* __restrict__ part,
                                          float* __restrict__ d1_out,
                                          float* __restrict__ d2_out,
                                          int* __restrict__ i1_out, int Kq,
                                          int S) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Kq) return;
  int d1 = kT2None, d2 = kT2None, i1 = -1;
  for (int s = 0; s < S; ++s) {
    const int nd1 = part[((size_t)0 * S + s) * Kq + q];
    const int nd2 = part[((size_t)1 * S + s) * Kq + q];
    const int ni1 = part[((size_t)2 * S + s) * Kq + q];
    const int m2 = min(max(d1, nd1), min(d2, nd2));
    if (nd1 < d1) i1 = ni1;
    d1 = min(d1, nd1);
    d2 = m2;
  }
  d1_out[q] = d1 >= kT2None ? 1e9f : (float)d1;
  d2_out[q] = d2 >= kT2None ? 1e9f : (float)d2;
  i1_out[q] = i1;
}

}  // namespace

// bits_q (Kq, 256) bf16, bits_t (Kt, 256) bf16 (16-byte aligned), part
// (3, S, Kq) i32 scratch -> d1, d2 (Kq,) f32, i1 (Kq,) i32. Targets
// [s * rows_per_split, (s + 1) * rows_per_split) form split s < S.
extern "C" int kmt_hamming_top2(const void* bits_q, const void* bits_t,
                                void* part, void* d1, void* d2, void* i1,
                                int Kq, int Kt, int rows_per_split, int S,
                                void* stream) {
  if (Kq <= 0 || Kt <= 0 || S <= 0 || S > 65535 || rows_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((Kq + kT2Queries - 1) / kT2Queries, S);
  hamming_top2_kernel<<<grid, kT2Threads, 0, st>>>(
      (const uint4*)bits_q, (const uint4*)bits_t, (int*)part, Kq, Kt,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hamming_top2_merge_kernel<<<(Kq + 127) / 128, 128, 0, st>>>(
      (const int*)part, (float*)d1, (float*)d2, (int*)i1, Kq, S);
  return (int)cudaGetLastError();
}
