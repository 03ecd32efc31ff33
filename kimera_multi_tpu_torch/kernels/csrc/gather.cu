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
// about it: threads of a warp are adjacent along the output's minor axis,
// so stores coalesce. K3 and K5 read by index, scattered over one
// candidate's (D, K) block of a few KB, which stays in L1/L2. An element of
// K4 is three dependent reads (picks, then order, then data), so its block
// owns one candidate and a tile of hypotheses and makes every global access
// contiguous: it stages the candidate's `order` and `data` in shared
// memory, loads its slab of `picks` (kPermTileH x k contiguous int32) with
// 16-byte loads, composes order[pick] in shared memory and writes each
// output row along h. Where `order` and `data` exceed kPermStageBytes (a
// large K or D) the same kernel reads both through the cache instead.
// Neither `order[picks]` nor `data[:, order]` is ever written to device
// memory. Indices are clamped to the valid range (as in the plain
// versions): an index from outside the contract never reads outside its
// candidate's block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

// out[c, m*D + i, h] = data[c, i, picks[c, h, m]]
__global__ void __launch_bounds__(kThreads)
sample_gather_kernel(const float* __restrict__ data,  // (C, D, K)
                     const int* __restrict__ picks,   // (C, H, k)
                     float* __restrict__ out,         // (C, k*D, H)
                     int D, int K, int H, int k) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  const int m = blockIdx.y;
  const int c = blockIdx.z;
  if (h >= H) return;
  const int j = clamp_index(picks[((size_t)c * H + h) * k + m], K);
  const float* src = data + (size_t)c * D * K + j;
  float* dst = out + ((size_t)c * k * D + (size_t)m * D) * H + h;
  for (int i = 0; i < D; ++i) dst[(size_t)i * H] = src[(size_t)i * K];
}

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

extern "C" int kmt_sample_gather_t(const void* data, const void* picks,
                                   void* out, int C, int D, int K, int H,
                                   int k, void* stream) {
  if (C <= 0 || H <= 0 || k <= 0) return (int)cudaGetLastError();
  dim3 grid((H + kThreads - 1) / kThreads, k, C);
  sample_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)picks, (float*)out, D, K, H, k);
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
