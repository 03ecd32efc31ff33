// Fused RANSAC hypothesis scoring (K8, K9, K7).
//
// Replace the Pallas kernels `_rigid_counts_kernel` (wrapper `rigid_counts`)
// and `_essential_counts_kernel` (wrapper `essential_counts`) of
// kimera_multi_tpu/kernels/score.py, and `_presel_counts_kernel` (wrapper
// `presel_counts`) of kimera_multi_tpu/kernels/fivept.py: per hypothesis,
// the number of valid correspondences whose residual is under the
// threshold. The (H, K) residual matrix is never written; the counts are
// the only output. The TPU kernels formed the residuals as matrix products
// of a hypothesis tile with the point block; here each residual is a
// thread's arithmetic on models held in registers.
//
// Bound on an H100: operations. Per chunk the inputs are a few tens of MB
// (models, points, flags, each read once) against C*H*K residuals of about
// 26 (rigid) or 40 (Sampson) f32 operations each, so the f32 pipes, not the
// memory, set the least time (K7: 1.0e10 operations per chunk against 147 MB
// of models). The library is built with -fmad=false and the expressions
// below are written in the order of the plain PyTorch versions
// (`rigid_counts_ref`, `essential_counts_ref` in kernels/score.py, which
// `presel_counts_ref` in kernels/fivept.py calls), so a residual within
// rounding of the threshold falls on the same side in both. Without
// contraction every operation is an instruction of its own, so what a
// residual costs beyond its operations (loads, a validity test, a
// division's slow path) is what a design can remove. Integer counts and no
// atomics: the result does not change from run to run.
//
// All three stage only the VALID correspondences of a tile (`stage_valid`:
// a block-wide prefix of __ballot_sync / __popc per warp), so no invalid
// point is scored and no flag is tested per residual (a count is a sum of
// 0/1 over the valid points, so their order is free), and pack a staged
// point as a float4 (a0, a1, a2, b0) and a float2 (b1, b2): two shared loads
// where there were seven, each serving several models.
//   K8 and K9: a block scores up to kHypsPerBlock hypotheses of one
//   candidate, staged with their 12 or 9 floats in shared memory; each
//   warp takes kHypsPerWarp of them into registers at a time while its
//   lanes stride the compacted points, and adds its warp sums to the
//   block's counts in shared memory (one warp owns each hypothesis). A
//   candidate's points are staged once per block.
//   K7 reads each (hypothesis, start) model in place from the entry-major
//   rows (C, 9 S, H) that K6 writes; a block takes one start and
//   kPreselHypsPerBlock hypotheses along x (coalesced loads), a thread
//   kModelsPerThread of them (h + j * kPreselThreads), so each broadcast
//   point serves four residuals.
// K7 and K9 keep the division off the common path, by the rule below
// (`count_sampson`); the launcher takes it for 2^-60 <= thr <= 1 and
// otherwise instantiates the kernel that divides for every residual.
//
// The decision rule of K7 and K9. The count asks whether
// err = RN(n / d) < thr, with n = RN(num * num), d = fmaxf(den, 1e-12) and
// RN float32 rounding to nearest. With tlo = RN(thr * (1 - 2^-20)),
// thi = RN(thr * (1 + 2^-20)), lo = RN(tlo * d) and hi = RN(thi * d):
//   (a) n < lo  implies  RN(n / d) < thr:  n / d < thr (1 - 2^-20)(1 + u)^2
//       < thr (1 - 2^-21) with u = 2^-24, while RN(x) >= thr needs
//       x >= thr (1 - 2^-24) (the float below a normal thr lies within
//       thr 2^-23 of it);
//   (b) n > hi  implies  RN(n / d) >= thr:  n / d > thr (1 + 2^-20)(1 - u)^2
//       > thr, and rounding is monotone with RN(thr) = thr;
//   (c) otherwise the kernel computes __fdiv_rn(n, d) < thr, the plain
//       version's own comparison.
// The (1 + u) factors need lo and hi normal: for 2^-60 <= thr <= 1 and
// d >= 1e-12 > 2^-40 both are at least 2^-101, and lo <= d is finite when d
// is. hi may overflow to inf: then n > hi is false and (c) decides. The
// launchers take the rule for such thresholds only (the path's is 1e-6)
// and divide always otherwise. Non-finite operands: n or d NaN makes both
// comparisons false, so (c) decides; d = inf makes lo = hi = inf, so a
// finite n is counted by (a), as n / inf = 0 is, and n = inf goes to (c)
// (inf / inf is NaN, not counted); n = inf with finite d fails (a) and is
// rejected by (b) where hi is finite, as inf < thr is false. The products
// are plain multiplies (-fmad=false leaves nothing to fuse them with); tlo
// and thi are rounded in float32, in the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K8 and K9: warps of a block, hypotheses a warp holds in registers at a
// time, hypotheses a block scores (12 or 9 KB of models), valid
// correspondences staged per pass (24 bytes each: 24 KB). ptxas held K9's
// rule instance at 64 registers with 12 bytes spilled; at least 3 blocks of
// 256 threads an SM allow 85 and leave none
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHypsPerWarp = 4;
constexpr int kHypsPerBlock = 256;
constexpr int kTile = 1024;
constexpr int kEssMinBlocks = 3;
// K7: threads of a block, models (hypotheses) a thread owns, hypotheses a
// block scores, valid preselect points staged per pass (6 KB)
constexpr int kPreselThreads = 128;
constexpr int kModelsPerThread = 4;
constexpr int kPreselHypsPerBlock = kPreselThreads * kModelsPerThread;
constexpr int kPreselTile = 256;
// ptxas held K7 at 64 registers with spills; at least 6 blocks of 128
// threads an SM allow 80 and leave none
constexpr int kPreselMinBlocks = 6;
// The decision rule of K7 and K9: margins 1 -+ 2^-20, and the thresholds
// it is valid for
constexpr float kBelow = 1.0f - 0x1p-20f;
constexpr float kAbove = 1.0f + 0x1p-20f;
constexpr float kRuleMinThr = 0x1p-60f;
constexpr float kRuleMaxThr = 1.0f;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c += 1 where x < y (false for NaN): one compare and one predicated add,
// where the compiler makes `c += x < y` a select and moves
__device__ __forceinline__ void add_if_less(int& c, float x, float y) {
  asm("{\n\t.reg .pred lt;\n\tsetp.lt.f32 lt, %1, %2;\n\t"
      "@lt add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "f"(x), "f"(y));
}

// Stage the VALID columns among [k0, k0+nk) of two (3, K) arrays, in their
// order, packed as sa[j] = (a0, a1, a2, b0), sb[j] = (b1, b2); returns how
// many. Every thread of the block calls it, after a barrier that ends all
// reads of sa and sb; it ends with one. The shared-memory pointers carry no
// __restrict__: other threads write what they point to between barriers,
// and a restrict pointer lets the compiler reuse a value loaded before one.
template <int kBlock>
__device__ __forceinline__ int stage_valid(
    const float* __restrict__ a, const float* __restrict__ b,
    const uint8_t* __restrict__ valid, int K, int k0, int nk,
    float4* sa, float2* sb, int* warp_n) {
  constexpr int kBlockWarps = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int i0 = 0; i0 < nk; i0 += kBlock) {
    const int i = i0 + threadIdx.x;
    const bool v = i < nk && valid[k0 + i];
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int off = base, total = 0;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) {
      const int n = warp_n[w];
      off += w < warp ? n : 0;
      total += n;
    }
    if (v) {
      const int j = off + __popc(ballot & ((1u << lane) - 1u));
      const int g = k0 + i;
      sa[j] = make_float4(a[g], a[K + g], a[2 * K + g], b[g]);
      sb[j] = make_float2(b[K + g], b[2 * K + g]);
    }
    base += total;
    __syncthreads();
  }
  return base;
}

// The two operands of the squared Sampson error num^2 / max(den, 1e-12)
// of the row-major model M at the bearing pair (a, b): n = num^2 and
// d = max(den, 1e-12), with num = b . (M a) and
// den = (M a)_x^2 + (M a)_y^2 + (M^T b)_x^2 + (M^T b)_y^2, in the order of
// `essential_counts_ref`.
__device__ __forceinline__ void sampson_parts(const float* M, float a0,
                                              float a1, float a2, float b0,
                                              float b1, float b2, float& n,
                                              float& d) {
  const float ef0 = (M[0] * a0 + M[1] * a1) + M[2] * a2;
  const float ef1 = (M[3] * a0 + M[4] * a1) + M[5] * a2;
  const float ef2 = (M[6] * a0 + M[7] * a1) + M[8] * a2;
  const float et0 = (M[0] * b0 + M[3] * b1) + M[6] * b2;
  const float et1 = (M[1] * b0 + M[4] * b1) + M[7] * b2;
  const float num = (b0 * ef0 + b1 * ef1) + b2 * ef2;
  const float den = ((ef0 * ef0 + ef1 * ef1) + et0 * et0) + et1 * et1;
  n = num * num;
  d = fmaxf(den, 1e-12f);
}

// cnt[j] += 1 for each model M[j] whose squared Sampson error at the staged
// point (A, B) is under thr. kRule: by the rule of the note above, with
// tlo = RN(thr (1 - 2^-20)), thi = RN(thr (1 + 2^-20)), dividing only where
// it cannot decide; else by the division.
template <bool kRule, int kModels>
__device__ __forceinline__ void count_sampson(const float (*M)[9],
                                              const float4 A, const float2 B,
                                              float tlo, float thi, float thr,
                                              int* cnt) {
  float nn[kModels], dd[kModels];
  bool undecided[kModels];
  bool any_undecided = false;
#pragma unroll
  for (int j = 0; j < kModels; ++j) {
    sampson_parts(M[j], A.x, A.y, A.z, A.w, B.x, B.y, nn[j], dd[j]);
    if (kRule) {
      const float lo = tlo * dd[j], hi = thi * dd[j];
      add_if_less(cnt[j], nn[j], lo);
      undecided[j] = !(nn[j] < lo || nn[j] > hi);
      any_undecided |= undecided[j];
    } else {
      cnt[j] += __fdiv_rn(nn[j], dd[j]) < thr;
    }
  }
  if (kRule && any_undecided) {
#pragma unroll
    for (int j = 0; j < kModels; ++j)
      if (undecided[j]) cnt[j] += __fdiv_rn(nn[j], dd[j]) < thr;
  }
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
  __shared__ float4 sa[kTile];
  __shared__ float2 sb[kTile];
  __shared__ float4 shyp[3 * kHypsPerBlock];  // R row-major, then t
  __shared__ int scount[kHypsPerBlock];
  __shared__ int warp_n[kWarps];

  const int c = blockIdx.y;
  const int hb = blockIdx.x * kHypsPerBlock;
  const int nh = min(kHypsPerBlock, H - hb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* sh = reinterpret_cast<float*>(shyp);
  const float* Rc = R + ((size_t)c * H + hb) * 9;
  const float* tc = t + ((size_t)c * H + hb) * 3;
  for (int i = threadIdx.x; i < nh * 9; i += kThreads)
    sh[(i / 9) * 12 + i % 9] = Rc[i];
  for (int i = threadIdx.x; i < nh * 3; i += kThreads)
    sh[(i / 3) * 12 + 9 + i % 3] = tc[i];
  for (int i = threadIdx.x; i < kHypsPerBlock; i += kThreads)
    scount[i] = 0;

  const float* pc = p + (size_t)c * 3 * K;
  const float* qc = q + (size_t)c * 3 * K;
  const uint8_t* vc = valid + (size_t)c * K;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    __syncthreads();
    const int n = stage_valid<kThreads>(pc, qc, vc, K, k0,
                                        min(kTile, K - k0), sa, sb, warp_n);
    for (int g = warp * kHypsPerWarp; g < nh; g += kWarps * kHypsPerWarp) {
      float M[kHypsPerWarp][12];
      int cnt[kHypsPerWarp];
#pragma unroll
      for (int j = 0; j < kHypsPerWarp; ++j) {
        const bool live = g + j < nh;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float4 m = live ? shyp[3 * (g + j) + r]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          M[j][4 * r] = m.x;
          M[j][4 * r + 1] = m.y;
          M[j][4 * r + 2] = m.z;
          M[j][4 * r + 3] = m.w;
        }
        cnt[j] = 0;
      }
      for (int k = lane; k < n; k += 32) {
        const float4 A = sa[k];
        const float2 B = sb[k];
        const float p0 = A.x, p1 = A.y, p2 = A.z;
        const float q0 = A.w, q1 = B.x, q2 = B.y;
#pragma unroll
        for (int j = 0; j < kHypsPerWarp; ++j) {
          const float* m = M[j];
          const float r0 = q0 - (((m[0] * p0 + m[1] * p1) + m[2] * p2) + m[9]);
          const float r1 = q1 - (((m[3] * p0 + m[4] * p1) + m[5] * p2) + m[10]);
          const float r2 = q2 - (((m[6] * p0 + m[7] * p1) + m[8] * p2) + m[11]);
          const float d2 = (r0 * r0 + r1 * r1) + r2 * r2;
          add_if_less(cnt[j], d2, thr2);
        }
      }
#pragma unroll
      for (int j = 0; j < kHypsPerWarp; ++j) {
        const int s = warp_sum(cnt[j]);
        if (lane == 0 && g + j < nh) scount[g + j] += s;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh; i += kThreads)
    out[(size_t)c * H + hb + i] = scount[i];
}

// count[c, h] = #{k valid : num^2 / max(den, 1e-12) < thr} with
// num = f2 . (E f1), den = (E f1)_x^2 + (E f1)_y^2 + (E^T f2)_x^2
// + (E^T f2)_y^2. kRule: decide by the rule of the note above, dividing
// only where it cannot.
template <bool kRule>
__global__ void __launch_bounds__(kThreads, kEssMinBlocks)
essential_counts_kernel(const float* __restrict__ E,   // (C, H, 9) row-major
                        const float* __restrict__ f1,  // (C, 3, K)
                        const float* __restrict__ f2,  // (C, 3, K)
                        const uint8_t* __restrict__ valid,  // (C, K)
                        int* __restrict__ out,              // (C, H)
                        int H, int K, float thr) {
  __shared__ float4 sa[kTile];
  __shared__ float2 sb[kTile];
  __shared__ float shyp[9 * kHypsPerBlock];
  __shared__ int scount[kHypsPerBlock];
  __shared__ int warp_n[kWarps];

  const int c = blockIdx.y;
  const int hb = blockIdx.x * kHypsPerBlock;
  const int nh = min(kHypsPerBlock, H - hb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const float* Ec = E + ((size_t)c * H + hb) * 9;
  for (int i = threadIdx.x; i < nh * 9; i += kThreads) shyp[i] = Ec[i];
  for (int i = threadIdx.x; i < kHypsPerBlock; i += kThreads)
    scount[i] = 0;
  const float tlo = thr * kBelow, thi = thr * kAbove;

  const float* ac = f1 + (size_t)c * 3 * K;
  const float* bc = f2 + (size_t)c * 3 * K;
  const uint8_t* vc = valid + (size_t)c * K;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    __syncthreads();
    const int n = stage_valid<kThreads>(ac, bc, vc, K, k0,
                                        min(kTile, K - k0), sa, sb, warp_n);
    for (int g = warp * kHypsPerWarp; g < nh; g += kWarps * kHypsPerWarp) {
      // a model past nh is scored (as zeros) but not written
      float M[kHypsPerWarp][9];
      int cnt[kHypsPerWarp];
#pragma unroll
      for (int j = 0; j < kHypsPerWarp; ++j) {
        const bool live = g + j < nh;
#pragma unroll
        for (int e = 0; e < 9; ++e)
          M[j][e] = live ? shyp[9 * (g + j) + e] : 0.f;
        cnt[j] = 0;
      }
      for (int k = lane; k < n; k += 32)
        count_sampson<kRule, kHypsPerWarp>(M, sa[k], sb[k], tlo, thi, thr,
                                           cnt);
#pragma unroll
      for (int j = 0; j < kHypsPerWarp; ++j) {
        const int s = warp_sum(cnt[j]);
        if (lane == 0 && g + j < nh) scount[g + j] += s;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh; i += kThreads)
    out[(size_t)c * H + hb + i] = scount[i];
}

// count[c, h, s] = #{p valid : Sampson error of E_hs at p < thr}, with
// model (h, s) read from the entry-major rows E[c, e*S + s, h]. kRule: decide
// by the rule of the note above, dividing only where it cannot.
template <bool kRule>
__global__ void __launch_bounds__(kPreselThreads, kPreselMinBlocks)
presel_counts_kernel(const float* __restrict__ E,   // (C, 9 S, H)
                     const float* __restrict__ f1,  // (C, 3, P)
                     const float* __restrict__ f2,  // (C, 3, P)
                     const uint8_t* __restrict__ valid,  // (C, P)
                     int* __restrict__ out,              // (C, H, S)
                     int H, int S, int P, float thr) {
  __shared__ float4 sa[kPreselTile];
  __shared__ float2 sb[kPreselTile];
  __shared__ int warp_n[kPreselThreads / 32];

  const int h0 = blockIdx.x * kPreselHypsPerBlock + threadIdx.x;
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  // every thread stages; a model past H is scored (on hypothesis 0's
  // entries) but not written
  float M[kModelsPerThread][9];
  int cnt[kModelsPerThread];
#pragma unroll
  for (int j = 0; j < kModelsPerThread; ++j) {
    const int h = h0 + j * kPreselThreads;
    const float* Ec = E + ((size_t)c * 9 * S + s) * H + (h < H ? h : 0);
#pragma unroll
    for (int e = 0; e < 9; ++e) M[j][e] = Ec[(size_t)e * S * H];
    cnt[j] = 0;
  }
  const float tlo = thr * kBelow, thi = thr * kAbove;

  const float* ac = f1 + (size_t)c * 3 * P;
  const float* bc = f2 + (size_t)c * 3 * P;
  const uint8_t* vc = valid + (size_t)c * P;
  for (int k0 = 0; k0 < P; k0 += kPreselTile) {
    __syncthreads();
    const int n = stage_valid<kPreselThreads>(
        ac, bc, vc, P, k0, min(kPreselTile, P - k0), sa, sb, warp_n);
    for (int k = 0; k < n; ++k)
      count_sampson<kRule, kModelsPerThread>(M, sa[k], sb[k], tlo, thi, thr,
                                             cnt);
  }
#pragma unroll
  for (int j = 0; j < kModelsPerThread; ++j) {
    const int h = h0 + j * kPreselThreads;
    if (h < H) out[((size_t)c * H + h) * S + s] = cnt[j];
  }
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
  const bool rule = thr >= kRuleMinThr && thr <= kRuleMaxThr;
  if (rule)
    essential_counts_kernel<true><<<grid, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)E, (const float*)f1, (const float*)f2,
        (const uint8_t*)valid, (int*)out, H, K, thr);
  else
    essential_counts_kernel<false><<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const float*)E, (const float*)f1, (const float*)f2,
        (const uint8_t*)valid, (int*)out, H, K, thr);
  return (int)cudaGetLastError();
}

extern "C" int kmt_presel_counts(const void* E, const void* f1, const void* f2,
                                 const void* valid, void* out, int C, int H,
                                 int S, int P, float thr, void* stream) {
  if (C <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  dim3 grid((H + kPreselHypsPerBlock - 1) / kPreselHypsPerBlock, S, C);
  const bool rule = thr >= kRuleMinThr && thr <= kRuleMaxThr;
  if (rule)
    presel_counts_kernel<true><<<grid, kPreselThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const float*)E, (const float*)f1, (const float*)f2,
        (const uint8_t*)valid, (int*)out, H, S, P, thr);
  else
    presel_counts_kernel<false><<<grid, kPreselThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)E, (const float*)f1, (const float*)f2,
        (const uint8_t*)valid, (int*)out, H, S, P, thr);
  return (int)cudaGetLastError();
}
