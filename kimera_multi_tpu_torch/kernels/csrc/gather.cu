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
// so stores coalesce; the reads are scattered over one candidate's (D, K)
// block of a few KB, which stays in L1/L2. Neither `order[picks]` nor
// `data[:, order]` is ever written to memory. Indices are clamped to the
// valid range (as in the plain versions): an index from outside the
// contract never reads outside its candidate's block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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

// out[c, m*D + i, h] = data[c, i, order[c, picks[c, h, m]]]
__global__ void __launch_bounds__(kThreads)
sample_gather_perm_kernel(const float* __restrict__ data,  // (C, D, K)
                          const int* __restrict__ picks,   // (C, H, k)
                          const int* __restrict__ order,   // (C, K)
                          float* __restrict__ out,         // (C, k*D, H)
                          int D, int K, int H, int k) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  const int m = blockIdx.y;
  const int c = blockIdx.z;
  if (h >= H) return;
  const int pick = clamp_index(picks[((size_t)c * H + h) * k + m], K);
  const int j = clamp_index(order[(size_t)c * K + pick], K);
  const float* src = data + (size_t)c * D * K + j;
  float* dst = out + ((size_t)c * k * D + (size_t)m * D) * H + h;
  for (int i = 0; i < D; ++i) dst[(size_t)i * H] = src[(size_t)i * K];
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
  dim3 grid((H + kThreads - 1) / kThreads, k, C);
  sample_gather_perm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
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
