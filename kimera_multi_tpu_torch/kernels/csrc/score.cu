// Fused RANSAC hypothesis scoring (K8, K9, K7).
//
// Replace the Pallas kernels `_rigid_counts_kernel` (wrapper `rigid_counts`)
// and `_essential_counts_kernel` (wrapper `essential_counts`) of
// kimera_multi_tpu/kernels/score.py, and `_presel_counts_kernel` (wrapper
// `presel_counts`) of kimera_multi_tpu/kernels/fivept.py: per hypothesis,
// the number of valid correspondences whose residual is under the
// threshold. The (H, K) residual matrix is never written; the counts are
// the only output.
//
// The TPU kernels formed the residuals as matrix products of a hypothesis
// tile with the point block. Here one warp owns kHypsPerWarp hypotheses,
// whose 12 (or 9) model floats sit in registers; its lanes stride the
// correspondences, which the block staged once in shared memory.
//
// Bound on an H100: operations. Per chunk the inputs are a few tens of MB
// (models, points, flags, each read once) against C*H*K residuals of about
// 30 (rigid) or 45 (essential) f32 operations each, so the f32 pipes, not
// the memory, set the least time. What the design does about it: a lane
// loads a correspondence from shared memory once and scores it against
// kHypsPerWarp models, which brings the shared-memory loads per residual
// under the arithmetic; counts are summed in registers and reduced with
// warp shuffles. Integer counts and no atomics: the result does not change
// from run to run.
//
// K7 scores the 5-point path's raw models, S starts per hypothesis, on the
// P (64) preselect correspondences, reading each model in place from the
// entry-major rows (C, 9 S, H) that K6 writes. One thread owns one
// (hypothesis, start) model in registers; the block's x axis runs along
// hypotheses, so the 9 loads of a warp are 9 coalesced lines; the P points
// of the candidate are staged in shared memory once and read as
// broadcasts. Bound: operations, C*H*S*P residuals of ~40 f32 operations
// (1.0e10 per chunk) against 147 MB of models.
//
// The library is built with -fmad=false and the expressions below are
// written in the order of the plain PyTorch versions (`rigid_counts_ref`,
// `essential_counts_ref` in kernels/score.py, which `presel_counts_ref` in
// kernels/fivept.py calls), so a residual within rounding of the threshold
// falls on the same side in both. K9 and K7 share one Sampson expression.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHypsPerWarp = 4;
constexpr int kHypsPerBlock = kWarps * kHypsPerWarp;
constexpr int kTileK = 1024;  // correspondences staged per pass (28 KB)
constexpr int kTileP = 256;   // preselect points staged per pass (K7)

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [k0, k0+nk) of two (3, K) arrays and the valid flags.
template <int kTile>
__device__ __forceinline__ void stage_points(
    const float* __restrict__ a, const float* __restrict__ b,
    const uint8_t* __restrict__ valid, int K, int k0, int nk,
    float (*sa)[kTile], float (*sb)[kTile], int* sv) {
  for (int i = threadIdx.x; i < nk; i += kThreads) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      sa[r][i] = a[(size_t)r * K + k0 + i];
      sb[r][i] = b[(size_t)r * K + k0 + i];
    }
    sv[i] = valid[k0 + i];
  }
}

// Squared Sampson error num^2 / max(den, 1e-12) of the row-major model M
// at the bearing pair (a, b): num = b . (M a),
// den = (M a)_x^2 + (M a)_y^2 + (M^T b)_x^2 + (M^T b)_y^2
__device__ __forceinline__ float sampson_err(const float* M, float a0,
                                             float a1, float a2, float b0,
                                             float b1, float b2) {
  const float ef0 = (M[0] * a0 + M[1] * a1) + M[2] * a2;
  const float ef1 = (M[3] * a0 + M[4] * a1) + M[5] * a2;
  const float ef2 = (M[6] * a0 + M[7] * a1) + M[8] * a2;
  const float et0 = (M[0] * b0 + M[3] * b1) + M[6] * b2;
  const float et1 = (M[1] * b0 + M[4] * b1) + M[7] * b2;
  const float num = (b0 * ef0 + b1 * ef1) + b2 * ef2;
  const float den = ((ef0 * ef0 + ef1 * ef1) + et0 * et0) + et1 * et1;
  return (num * num) / fmaxf(den, 1e-12f);
}

// count[c, h] = #{k valid : || q_k - (R_h p_k + t_h) ||^2 < thr2}
__global__ void __launch_bounds__(kThreads)
rigid_counts_kernel(const float* __restrict__ R,  // (C, H, 9) row-major
                    const float* __restrict__ t,  // (C, H, 3)
                    const float* __restrict__ p,  // (C, 3, K)
                    const float* __restrict__ q,  // (C, 3, K)
                    const uint8_t* __restrict__ valid,  // (C, K)
                    int* __restrict__ out,              // (C, H)
                    int H, int K, float thr2) {
  __shared__ float sp[3][kTileK];
  __shared__ float sq[3][kTileK];
  __shared__ int sv[kTileK];

  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = (blockIdx.x * kWarps + warp) * kHypsPerWarp;

  float Rm[kHypsPerWarp][9], tm[kHypsPerWarp][3];
  int cnt[kHypsPerWarp];
#pragma unroll
  for (int j = 0; j < kHypsPerWarp; ++j) {
    const bool live = h0 + j < H;
    const size_t hh = (size_t)c * H + (live ? h0 + j : 0);
#pragma unroll
    for (int e = 0; e < 9; ++e) Rm[j][e] = live ? R[hh * 9 + e] : 0.f;
#pragma unroll
    for (int e = 0; e < 3; ++e) tm[j][e] = live ? t[hh * 3 + e] : 0.f;
    cnt[j] = 0;
  }

  const float* pc = p + (size_t)c * 3 * K;
  const float* qc = q + (size_t)c * 3 * K;
  const uint8_t* vc = valid + (size_t)c * K;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int nk = min(kTileK, K - k0);
    __syncthreads();
    stage_points<kTileK>(pc, qc, vc, K, k0, nk, sp, sq, sv);
    __syncthreads();
    for (int k = lane; k < nk; k += 32) {
      const float p0 = sp[0][k], p1 = sp[1][k], p2 = sp[2][k];
      const float q0 = sq[0][k], q1 = sq[1][k], q2 = sq[2][k];
      const int v = sv[k];
#pragma unroll
      for (int j = 0; j < kHypsPerWarp; ++j) {
        const float* M = Rm[j];
        const float r0 = q0 - (((M[0] * p0 + M[1] * p1) + M[2] * p2) + tm[j][0]);
        const float r1 = q1 - (((M[3] * p0 + M[4] * p1) + M[5] * p2) + tm[j][1]);
        const float r2 = q2 - (((M[6] * p0 + M[7] * p1) + M[8] * p2) + tm[j][2]);
        const float d2 = (r0 * r0 + r1 * r1) + r2 * r2;
        cnt[j] += (d2 < thr2) && v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kHypsPerWarp; ++j) {
    const int s = warp_sum(cnt[j]);
    if (lane == 0 && h0 + j < H) out[(size_t)c * H + h0 + j] = s;
  }
}

// Squared Sampson error num^2 / max(den, 1e-12) with num = f2 . (E f1),
// den = (E f1)_x^2 + (E f1)_y^2 + (E^T f2)_x^2 + (E^T f2)_y^2;
// count[c, h] = #{k valid : err < thr}
__global__ void __launch_bounds__(kThreads)
essential_counts_kernel(const float* __restrict__ E,   // (C, H, 9) row-major
                        const float* __restrict__ f1,  // (C, 3, K)
                        const float* __restrict__ f2,  // (C, 3, K)
                        const uint8_t* __restrict__ valid,  // (C, K)
                        int* __restrict__ out,              // (C, H)
                        int H, int K, float thr) {
  __shared__ float s1[3][kTileK];
  __shared__ float s2[3][kTileK];
  __shared__ int sv[kTileK];

  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = (blockIdx.x * kWarps + warp) * kHypsPerWarp;

  float Em[kHypsPerWarp][9];
  int cnt[kHypsPerWarp];
#pragma unroll
  for (int j = 0; j < kHypsPerWarp; ++j) {
    const bool live = h0 + j < H;
    const size_t hh = (size_t)c * H + (live ? h0 + j : 0);
#pragma unroll
    for (int e = 0; e < 9; ++e) Em[j][e] = live ? E[hh * 9 + e] : 0.f;
    cnt[j] = 0;
  }

  const float* ac = f1 + (size_t)c * 3 * K;
  const float* bc = f2 + (size_t)c * 3 * K;
  const uint8_t* vc = valid + (size_t)c * K;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int nk = min(kTileK, K - k0);
    __syncthreads();
    stage_points<kTileK>(ac, bc, vc, K, k0, nk, s1, s2, sv);
    __syncthreads();
    for (int k = lane; k < nk; k += 32) {
      const float a0 = s1[0][k], a1 = s1[1][k], a2 = s1[2][k];
      const float b0 = s2[0][k], b1 = s2[1][k], b2 = s2[2][k];
      const int v = sv[k];
#pragma unroll
      for (int j = 0; j < kHypsPerWarp; ++j)
        cnt[j] += (sampson_err(Em[j], a0, a1, a2, b0, b1, b2) < thr) && v;
    }
  }
#pragma unroll
  for (int j = 0; j < kHypsPerWarp; ++j) {
    const int s = warp_sum(cnt[j]);
    if (lane == 0 && h0 + j < H) out[(size_t)c * H + h0 + j] = s;
  }
}

// count[c, h, s] = #{p valid : sampson_err(E_hs, f1_p, f2_p) < thr}, with
// model (h, s) read from the entry-major rows E[c, e*S + s, h]
__global__ void __launch_bounds__(kThreads)
presel_counts_kernel(const float* __restrict__ E,   // (C, 9 S, H)
                     const float* __restrict__ f1,  // (C, 3, P)
                     const float* __restrict__ f2,  // (C, 3, P)
                     const uint8_t* __restrict__ valid,  // (C, P)
                     int* __restrict__ out,              // (C, H, S)
                     int H, int S, int P, float thr) {
  __shared__ float s1[3][kTileP];
  __shared__ float s2[3][kTileP];
  __shared__ int sv[kTileP];

  const int h = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  const bool live = h < H;  // every thread stages; only live ones count
  float M[9];
  const float* Ec = E + ((size_t)c * 9 * S + s) * H + (live ? h : 0);
#pragma unroll
  for (int e = 0; e < 9; ++e) M[e] = Ec[(size_t)e * S * H];

  const float* ac = f1 + (size_t)c * 3 * P;
  const float* bc = f2 + (size_t)c * 3 * P;
  const uint8_t* vc = valid + (size_t)c * P;
  int cnt = 0;
  for (int k0 = 0; k0 < P; k0 += kTileP) {
    const int nk = min(kTileP, P - k0);
    __syncthreads();
    stage_points<kTileP>(ac, bc, vc, P, k0, nk, s1, s2, sv);
    __syncthreads();
    for (int k = 0; k < nk; ++k)
      cnt += (sampson_err(M, s1[0][k], s1[1][k], s1[2][k], s2[0][k],
                          s2[1][k], s2[2][k]) < thr) &&
             sv[k];
  }
  if (live) out[((size_t)c * H + h) * S + s] = cnt;
}

}  // namespace

extern "C" int kmt_rigid_counts(const void* R, const void* t, const void* p,
                                const void* q, const void* valid, void* out,
                                int C, int H, int K, float thr2,
                                void* stream) {
  if (C <= 0 || H <= 0) return (int)cudaGetLastError();
  dim3 grid((H + kHypsPerBlock - 1) / kHypsPerBlock, C);
  rigid_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, (const float*)p, (const float*)q,
      (const uint8_t*)valid, (int*)out, H, K, thr2);
  return (int)cudaGetLastError();
}

extern "C" int kmt_essential_counts(const void* E, const void* f1,
                                    const void* f2, const void* valid,
                                    void* out, int C, int H, int K, float thr,
                                    void* stream) {
  if (C <= 0 || H <= 0) return (int)cudaGetLastError();
  dim3 grid((H + kHypsPerBlock - 1) / kHypsPerBlock, C);
  essential_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)E, (const float*)f1, (const float*)f2,
      (const uint8_t*)valid, (int*)out, H, K, thr);
  return (int)cudaGetLastError();
}

extern "C" int kmt_presel_counts(const void* E, const void* f1, const void* f2,
                                 const void* valid, void* out, int C, int H,
                                 int S, int P, float thr, void* stream) {
  if (C <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  dim3 grid((H + kThreads - 1) / kThreads, S, C);
  presel_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)E, (const float*)f1, (const float*)f2,
      (const uint8_t*)valid, (int*)out, H, S, P, thr);
  return (int)cudaGetLastError();
}
