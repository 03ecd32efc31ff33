// Minimal-sample gathers (K3, K4, K5).
//
// Replace the Pallas kernels `_sample_gather_kernel` (wrapper
// `sample_gather_t`), `_sample_gather_perm_kernel` (wrapper
// `sample_gather_perm_t`) and `_permute_cols_kernel` (wrapper
// `permute_cols`) of kimera_multi_tpu/kernels/gather.py. On the TPU a
// gather was a one-hot matrix product built in fast memory, because its
// gather unit runs near-serially. A GPU loads by index: each output element
// is one (composed) indexed load.
//
// Bound on an H100: bytes. Every output element is written once and every
// input read at least once; there is no arithmetic. What the design does
// about it: threads of a warp are adjacent along the output's minor axis, so
// stores coalesce, and indices come in as contiguous slabs. A block of K3
// takes 256 consecutive (candidate, hypothesis) pairs, so its lanes fill
// whatever H is (at the verification path's H = 64, four candidates a
// block). At k = 1, D = 3 (the path) a thread loads its own pick, so a
// warp's loads are one contiguous 128-byte slab, and nothing waits on a
// barrier; at any other k or D the block loads its pairs' slab of `picks`
// (up to kGatherTileM sample points of each, contiguous int32) with 16-byte
// loads into shared memory. A thread issues its D data loads before its
// first store. Its data is read by index through the cache: at that shape a
// candidate's (D, K) block is reached at no more than 64 of its 704
// columns, and the time is two dependent loads (pick, then data) above the
// launch floor. K5 reads by index, scattered over one candidate's (D, K)
// block of a few KB, which stays in L1/L2. An element of K4 is three
// dependent reads (picks, then order, then data), so its block owns one
// candidate and a tile of hypotheses and makes every global access
// contiguous: it stages the candidate's `order` and `data` in shared
// memory, loads its slab of `picks` (kPermTileH x k contiguous int32) with
// 16-byte loads, composes order[pick] in shared memory and writes each
// output row along h. Where `order` and
// `data` exceed kPermStageBytes (a large K or D) the same kernel reads both
// through the cache instead. Neither `order[picks]` nor `data[:, order]` is
// ever written to device memory. Indices are clamped to the valid range (as
// in the plain versions): an index from outside the contract never reads
// outside its candidate's block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// K3: (candidate, hypothesis) pairs of a block (one a thread), sample
// points of one pass (k up to this many take one pass, their picks one
// contiguous slab), and the row stride of the staged picks (padded off the
// bank period)
constexpr int kGatherPairs = 256;
constexpr int kGatherTileM = 8;
constexpr int kGatherStride = kGatherPairs + 1;
// K4: threads of a block, hypotheses a block gathers, sample points of one
// pass (k up to this many take one pass, their picks one contiguous slab),
// the row stride of the composed indices (padded off the bank period), and
// the most shared memory that `order` and `data` are staged in: what the
// composed indices leave of the 48 KB a block has without opting in
constexpr int kPermThreads = 256;
constexpr int kPermTileH = 512;
constexpr int kPermTileM = 8;
constexpr int kPermStride = kPermTileH + 1;
constexpr int kPermStageBytes =
    48 * 1024 - (int)sizeof(int) * kPermTileM * kPermStride;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// the slab src[0, n) of int32 (rows of k, row-major) into s[mm * stride +
// row]: 16-byte loads from the first aligned entry, single entries before
// it and after the last
template <int kBlock>
__device__ __forceinline__ void stage_slab(const int* __restrict__ src,
                                           int n, int k, int* s,
                                           int stride) {
  const int head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15) / 4);
  const int nv = (n - head) / 4;
  const int4* pv = reinterpret_cast<const int4*>(src + head);
  for (int v = threadIdx.x; v < nv; v += kBlock) {
    const int4 q = pv[v];
    const int t = head + 4 * v;
    int row = t / k, mm = t - row * k;
    const int e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[mm * stride + row] = e[u];
      if (++mm == k) {
        mm = 0;
        ++row;
      }
    }
  }
  const int rest = n - 4 * nv;  // head, then the tail
  if (threadIdx.x < rest) {
    const int t = threadIdx.x < head ? threadIdx.x : 4 * nv + threadIdx.x;
    s[(t % k) * stride + t / k] = src[t];
  }
}

// D rows of a point: out[i * H] = col[i * K], the loads issued before the
// first store (D = kD where kD > 0, else 4 rows at a time)
template <int kD>
__device__ __forceinline__ void copy_point(const float* __restrict__ col,
                                           float* __restrict__ out, int D,
                                           int K, int H) {
  if (kD > 0) {
    float v[kD > 0 ? kD : 1];
#pragma unroll
    for (int i = 0; i < kD; ++i) v[i] = __ldg(col + (size_t)i * K);
#pragma unroll
    for (int i = 0; i < kD; ++i) out[(size_t)i * H] = v[i];
    return;
  }
  for (int i0 = 0; i0 < D; i0 += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u < D) v[u] = __ldg(col + (size_t)(i0 + u) * K);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u < D) out[(size_t)(i0 + u) * H] = v[u];
  }
}

// k = 1, D = 3 (the path's shape): out[c, i, h] = data[c, i, picks[c, h,
// 0]] for the block's kGatherPairs consecutive pairs f = c H + h < n_pairs.
// A thread loads its pair's pick itself (a warp's loads are one contiguous
// 128-byte slab); no shared memory, no barrier.
__global__ void __launch_bounds__(kGatherPairs)
sample_point_kernel(const float* __restrict__ data,  // (C, 3, K)
                    const int* __restrict__ picks,   // (C, H, 1)
                    float* __restrict__ out,         // (C, 3, H)
                    int K, int H, int n_pairs) {
  const int f = blockIdx.x * kGatherPairs + threadIdx.x;
  if (f >= n_pairs) return;
  const int j = clamp_index(__ldg(picks + f), K);
  const int c = f / H, h = f - c * H;
  copy_point<3>(data + (size_t)c * 3 * K + j, out + (size_t)c * 3 * H + h,
                3, K, H);
}

// out[c, m*D + i, h] = data[c, i, picks[c, h, m]] for the block's
// kGatherPairs consecutive pairs f = c H + h < n_pairs, any k and D: the
// pairs' slab of picks staged, up to kGatherTileM sample points a pass.
__global__ void __launch_bounds__(kGatherPairs)
sample_gather_kernel(const float* __restrict__ data,  // (C, D, K)
                     const int* __restrict__ picks,   // (C, H, k)
                     float* __restrict__ out,         // (C, k*D, H)
                     int D, int K, int H, int k, int n_pairs) {
  __shared__ int sp[kGatherTileM * kGatherStride];  // [m][pair]: picks
  const int f0 = blockIdx.x * kGatherPairs;
  const int np = min(kGatherPairs, n_pairs - f0);
  const int f = f0 + threadIdx.x;
  const int c = f / H, h = f - c * H;
  const float* dc = data + (size_t)c * D * K;
  float* oc = out + (size_t)c * k * D * H + h;
  const int* pc = picks + (size_t)f0 * k;
  for (int m0 = 0; m0 < k; m0 += kGatherTileM) {
    const int mc = min(kGatherTileM, k - m0);
    if (m0) __syncthreads();  // the last pass's reads of sp done
    if (mc == k) {
      stage_slab<kGatherPairs>(pc, np * k, k, sp, kGatherStride);
    } else {
      for (int t = threadIdx.x; t < np * mc; t += kGatherPairs) {
        const int row = t / mc, mm = t - row * mc;
        sp[mm * kGatherStride + row] = pc[(size_t)row * k + m0 + mm];
      }
    }
    __syncthreads();
    if (threadIdx.x >= np) continue;
    for (int mm = 0; mm < mc; ++mm)
      copy_point<0>(
          dc + clamp_index(sp[mm * kGatherStride + threadIdx.x], K),
          oc + (size_t)(m0 + mm) * D * H, D, K, H);
  }
}

// Does nothing. Launched with K3's grid and block, its time is the floor
// of a launch of that shape.
__global__ void __launch_bounds__(kGatherPairs) empty_kernel() {}

// out[c, m*D + i, h] = data[c, i, order[c, picks[c, h, m]]] for the
// block's kPermTileH hypotheses h0 + hh of candidate c. kStaged: `order`
// (K int32), then `data` (D x K f32) sit in dynamic shared memory; else
// both are read through the cache.
template <bool kStaged>
__global__ void __launch_bounds__(kPermThreads)
sample_gather_perm_kernel(const float* __restrict__ data,  // (C, D, K)
                          const int* __restrict__ picks,   // (C, H, k)
                          const int* __restrict__ order,   // (C, K)
                          float* __restrict__ out,         // (C, k*D, H)
                          int D, int K, int H, int k) {
  extern __shared__ int stage[];
  __shared__ int sj[kPermTileM * kPermStride];  // [m][hh]: data column

  const int c = blockIdx.y;
  const int h0 = blockIdx.x * kPermTileH;
  const int nh = min(kPermTileH, H - h0);
  const float* dc = data + (size_t)c * D * K;
  const int* oc = order + (size_t)c * K;
  const int* pc = picks + ((size_t)c * H + h0) * k;
  int* sorder = stage;
  float* sdata = reinterpret_cast<float*>(stage + K);
  if (kStaged) {
    for (int i = threadIdx.x; i < K; i += kPermThreads) sorder[i] = oc[i];
    for (int i = threadIdx.x; i < D * K; i += kPermThreads) sdata[i] = dc[i];
  }
  // sample point mm of hypothesis hh picks `pick`: its data column
  auto compose = [&](int hh, int mm, int pick) {
    const int p = clamp_index(pick, K);
    sj[mm * kPermStride + hh] = clamp_index(kStaged ? sorder[p] : oc[p], K);
  };
  for (int m0 = 0; m0 < k; m0 += kPermTileM) {
    const int mc = min(kPermTileM, k - m0);
    __syncthreads();  // staged; the last pass's reads of sj done
    if (mc == k) {
      // the slab pc[0, nh k) is contiguous: 16-byte loads from the first
      // aligned entry, single entries before it and after the last
      const int n = nh * k;
      const int head = min(n, (int)((16 - ((uintptr_t)pc & 15)) & 15) / 4);
      const int nv = (n - head) / 4;
      const int4* pv = reinterpret_cast<const int4*>(pc + head);
      for (int v = threadIdx.x; v < nv; v += kPermThreads) {
        const int4 q = pv[v];
        const int t = head + 4 * v;
        int hh = t / k, mm = t - hh * k;
        const int e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          compose(hh, mm, e[u]);
          if (++mm == k) {
            mm = 0;
            ++hh;
          }
        }
      }
      const int rest = n - 4 * nv;  // head, then the tail
      if (threadIdx.x < rest) {
        const int t = threadIdx.x < head ? threadIdx.x
                                         : 4 * nv + threadIdx.x;
        compose(t / k, t % k, pc[t]);
      }
    } else {
      for (int t = threadIdx.x; t < nh * mc; t += kPermThreads) {
        const int hh = t / mc, mm = t - hh * mc;
        compose(hh, mm, pc[(size_t)hh * k + m0 + mm]);
      }
    }
    __syncthreads();
    // rows (m0 + mm) * D + i, each written along h
    float* dst = out + ((size_t)c * k + m0) * D * H + h0;
    for (int mm = 0; mm < mc; ++mm)
      for (int hh = threadIdx.x; hh < nh; hh += kPermThreads) {
        const int j = sj[mm * kPermStride + hh];
        for (int i = 0; i < D; ++i)
          dst[((size_t)mm * D + i) * H + hh] =
              kStaged ? sdata[i * K + j] : dc[(size_t)i * K + j];
      }
  }
}

// out[c, i, j] = data[c, i, idx[c, j]]
__global__ void __launch_bounds__(kThreads)
permute_cols_kernel(const float* __restrict__ data,  // (C, D, Kin)
                    const int* __restrict__ idx,     // (C, Kout)
                    float* __restrict__ out,         // (C, D, Kout)
                    int D, int Kin, int Kout) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (j >= Kout) return;
  const int s = clamp_index(idx[(size_t)c * Kout + j], Kin);
  const float* src = data + (size_t)c * D * Kin + s;
  float* dst = out + (size_t)c * D * Kout + j;
  for (int i = 0; i < D; ++i) dst[(size_t)i * Kout] = src[(size_t)i * Kin];
}

}  // namespace

// data (C, D, K) f32, picks (C, H, k) i32 -> out (C, k*D, H) f32; C * H
// below 2^31
extern "C" int kmt_sample_gather_t(const void* data, const void* picks,
                                   void* out, int C, int D, int K, int H,
                                   int k, void* stream) {
  if (C <= 0 || H <= 0 || k <= 0) return (int)cudaGetLastError();
  const long long n_pairs = (long long)C * H;
  if (n_pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n_pairs + kGatherPairs - 1) / kGatherPairs);
  const float* d = (const float*)data;
  const int* p = (const int*)picks;
  float* o = (float*)out;
  const int n = (int)n_pairs;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 1 && D == 3)
    sample_point_kernel<<<blocks, kGatherPairs, 0, st>>>(d, p, o, K, H, n);
  else
    sample_gather_kernel<<<blocks, kGatherPairs, 0, st>>>(d, p, o, D, K, H,
                                                          k, n);
  return (int)cudaGetLastError();
}

// The empty kernel with K3's grid and block for C candidates of H
// hypotheses (a measurement of the launch floor; on no path).
extern "C" int kmt_empty(int C, int H, void* stream) {
  const long long n_pairs = (long long)C * H;
  if (C <= 0 || H <= 0 || n_pairs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  empty_kernel<<<(int)((n_pairs + kGatherPairs - 1) / kGatherPairs),
                 kGatherPairs, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int kmt_sample_gather_perm_t(const void* data, const void* picks,
                                        const void* order, void* out, int C,
                                        int D, int K, int H, int k,
                                        void* stream) {
  if (C <= 0 || H <= 0 || k <= 0) return (int)cudaGetLastError();
  dim3 grid((H + kPermTileH - 1) / kPermTileH, C);
  const size_t stage = (size_t)(1 + D) * K * sizeof(int);
  if (stage <= (size_t)kPermStageBytes)
    sample_gather_perm_kernel<true><<<grid, kPermThreads, stage,
                                      (cudaStream_t)stream>>>(
        (const float*)data, (const int*)picks, (const int*)order, (float*)out,
        D, K, H, k);
  else
    sample_gather_perm_kernel<false><<<grid, kPermThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const float*)data, (const int*)picks, (const int*)order, (float*)out,
        D, K, H, k);
  return (int)cudaGetLastError();
}

extern "C" int kmt_permute_cols(const void* data, const void* idx, void* out,
                                int C, int D, int Kin, int Kout,
                                void* stream) {
  if (C <= 0 || Kout <= 0) return (int)cudaGetLastError();
  dim3 grid((Kout + kThreads - 1) / kThreads, C);
  permute_cols_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)idx, (float*)out, D, Kin, Kout);
  return (int)cudaGetLastError();
}
