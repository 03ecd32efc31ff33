// Pair Hamming top-2 search (K1).
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
