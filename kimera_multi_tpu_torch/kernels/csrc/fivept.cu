// Five-point essential-matrix generation (K6).
//
// Replaces the Pallas kernel `_fivept_kernel` (wrapper `fivept_models`) of
// kimera_multi_tpu/kernels/fivept.py. Per minimal sample of 5 bearing
// pairs: the 5 x 9 epipolar design rows, their 4-dim right nullspace by 5
// unrolled Householder reflections, then one start of the multi-start
// Gauss-Newton polish on the essential variety, written out as the raw
// (unprojected) model E = sum_s q_s B_s.
//
// The TPU kernel put the hypothesis axis in lanes and the start axis in
// sublanes of one (S, tile) array. Here one thread owns one (candidate,
// hypothesis) and kStartsPerThread (4) of its starts, polished one after
// the other, and keeps everything in registers: the design (45 floats),
// then the basis (36), then the polish state (Jacobian 40, normal matrix
// 16, E and its products ~50). The basis depends on the hypothesis only;
// the threads of a hypothesis (2 at 8 starts) each compute it (1.6e3
// operations, against 1.7e4 per start at 8 steps) rather than share it
// through shared memory and a barrier; ptxas places all of it in 128
// registers without spilling.
//
// Bound on an H100: operations. Per chunk (1024 candidates x 500
// hypotheses x 8 starts) the inputs are 61 MB and the output 147 MB,
// against 1.8e4 f32 operations per thread (7.5e10 in all). What the
// design does about it: no memory traffic inside the polish at all; the
// grid's x axis runs along hypotheses, so a warp's loads of one sample
// coordinate and its stores of one model entry (out[c, e*S + s, h]) are
// each one coalesced 128-byte line; and the library is built with FMA
// contraction (kernels/_build.py), so the dot products, the combinations
// of the basis and the Jacobian's 3-term sums issue one FFMA where an
// unfused build issued an FMUL and an FADD.
//
// Agreement with the plain version (`_fivept_models_ref` in
// kernels/fivept.py): every expression below repeats the plain version's
// operations in its order (sums left to right from their first term,
// `1.0 / x` as one division, `step_cap / x` as PyTorch evaluates it,
// x.reciprocal() * step_cap, clamps that pass NaN through), with IEEE
// division and square root. A fused multiply-add rounds once where the
// plain version rounds twice, so the two agree within rounding before the
// polish (3e-5 plus a multiple of the 5 x 9 design's condition number
// times float32's unit roundoff) and, the polish being a root finder, by
// shares after it: the stated contract is in
// chip_smoke.py and tests/test_torch_cuda_kernels.py. The models are
// proposals; K7 and K9 judge them by exact counts.
//
// kMinBlocks is the second argument of __launch_bounds__: 4 blocks of 128
// threads on each SM cap a thread at 128 registers, which hold the polish
// without spilling (5 or more blocks spill). kStartsPerThread is how many
// starts one thread polishes in turn after computing its hypothesis's
// basis once. Both were chosen by timing the alternatives on an H100
// (PERF.md, section 6).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;
constexpr int kStartsPerThread = 4;
constexpr float kEps = 1e-12f;

// torch.clamp(x, min=lo) / torch.clamp(x, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x) ? x : (x > lo ? x : lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return (x != x) ? x : (x < hi ? x : hi);
}

// Right-nullspace basis B[s][i] (s in 0..3) of the 5 x 9 design
// row_j[3 r + c] = f2_j[r] * f1_j[c]; f1, f2 point at sample coordinate 0
// of this hypothesis, coordinates H apart.
__device__ __forceinline__ void nullspace5(const float* __restrict__ f1,
                                           const float* __restrict__ f2,
                                           int H, float B[4][9]) {
  float A[9][5];  // A[i][j] = row_j[i]
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    float a[3], b[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a[d] = f1[(size_t)(3 * j + d) * H];
      b[d] = f2[(size_t)(3 * j + d) * H];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) A[3 * r + c][j] = b[r] * a[c];
  }
  float V[5][9];  // Householder vectors, entries i >= j of row j
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    float alpha2 = A[j][j] * A[j][j];
#pragma unroll
    for (int i = j + 1; i < 9; ++i) alpha2 = alpha2 + A[i][j] * A[i][j];
    const float alpha = sqrtf(clamp_min(alpha2, kEps));
    const float sign = A[j][j] >= 0.f ? 1.f : -1.f;
    float v[9];
#pragma unroll
    for (int i = j; i < 9; ++i) v[i] = A[i][j];
    v[j] = A[j][j] + sign * alpha;
    float vn2 = v[j] * v[j];
#pragma unroll
    for (int i = j + 1; i < 9; ++i) vn2 = vn2 + v[i] * v[i];
    const float inv = 1.f / sqrtf(clamp_min(vn2, kEps));
#pragma unroll
    for (int i = j; i < 9; ++i) v[i] = v[i] * inv;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float d = v[j] * A[j][c];
#pragma unroll
      for (int i = j + 1; i < 9; ++i) d = d + v[i] * A[i][c];
      const float coef = 2.f * d;
#pragma unroll
      for (int i = j; i < 9; ++i) A[i][c] = A[i][c] - v[i] * coef;
    }
#pragma unroll
    for (int i = j; i < 9; ++i) V[j][i] = v[i];
  }
#pragma unroll
  for (int col = 5; col < 9; ++col) {
    float q[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) q[i] = i == col ? 1.f : 0.f;
#pragma unroll
    for (int j = 4; j >= 0; --j) {
      float dot = V[j][j] * q[j];
#pragma unroll
      for (int i = j + 1; i < 9; ++i) dot = dot + V[j][i] * q[i];
#pragma unroll
      for (int i = j; i < 9; ++i) q[i] = q[i] - (2.f * V[j][i]) * dot;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) B[col - 5][i] = q[i];
  }
}

// E = ((q0 B0 + q1 B1) + q2 B2) + q3 B3, entry by entry
__device__ __forceinline__ void combine(const float B[4][9], const float q[4],
                                        float E[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
    E[i] = ((q[0] * B[0][i] + q[1] * B[1][i]) + q[2] * B[2][i]) +
           q[3] * B[3][i];
}

// One Gauss-Newton step of soa.essential5_polish_soa (kernels/soa.py).
__device__ __forceinline__ void gn_step(const float B[4][9], float q[4],
                                        float step_cap, float damping) {
  float E[9];
  combine(B, q, E);
  float EEt[3][3], EtE[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      EEt[r][c] = (E[3 * r] * E[3 * c] + E[3 * r + 1] * E[3 * c + 1]) +
                  E[3 * r + 2] * E[3 * c + 2];
      EtE[r][c] = (E[r] * E[c] + E[3 + r] * E[3 + c]) + E[6 + r] * E[6 + c];
    }
  const float tr = (EEt[0][0] + EEt[1][1]) + EEt[2][2];

  // residual [det(E), vec(2 E E^T E - tr E)]
  float res[10];
  res[0] = (E[0] * (E[4] * E[8] - E[5] * E[7]) -
            E[1] * (E[3] * E[8] - E[5] * E[6])) +
           E[2] * (E[3] * E[7] - E[4] * E[6]);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      res[1 + 3 * r + c] =
          2.f * ((EEt[r][0] * E[c] + EEt[r][1] * E[3 + c]) +
                 EEt[r][2] * E[6 + c]) -
          tr * E[3 * r + c];

  float cof[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int r1 = (r + 1) % 3, r2 = (r + 2) % 3;
      const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
      cof[r][c] = E[3 * r1 + c1] * E[3 * r2 + c2] -
                  E[3 * r1 + c2] * E[3 * r2 + c1];
    }

  // analytic Jacobian columns J[s][k] (4 x 10)
  float J[4][10];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* V = B[s];
    float d_det = cof[0][0] * V[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) d_det = d_det + cof[i / 3][i % 3] * V[i];
    float trEV = E[0] * V[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) trEV = trEV + E[i] * V[i];
    float VtE[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        VtE[r][c] = (V[r] * E[c] + V[3 + r] * E[3 + c]) + V[6 + r] * E[6 + c];
    J[s][0] = d_det;
    const float two_trEV = 2.f * trEV;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float m_a = (V[3 * r] * EtE[0][c] + V[3 * r + 1] * EtE[1][c]) +
                          V[3 * r + 2] * EtE[2][c];
        const float m_b = (E[3 * r] * VtE[0][c] + E[3 * r + 1] * VtE[1][c]) +
                          E[3 * r + 2] * VtE[2][c];
        const float m_c = (EEt[r][0] * V[c] + EEt[r][1] * V[3 + c]) +
                          EEt[r][2] * V[6 + c];
        J[s][1 + 3 * r + c] = (2.f * ((m_a + m_b) + m_c) -
                               two_trEV * E[3 * r + c]) -
                              tr * V[3 * r + c];
      }
  }

  // project the radial gauge direction out of J
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float dk = ((J[0][k] * q[0] + J[1][k] * q[1]) + J[2][k] * q[2]) +
                     J[3][k] * q[3];
#pragma unroll
    for (int s = 0; s < 4; ++s) J[s][k] = J[s][k] - dk * q[s];
  }

  // normal equations + damping, gradient
  float N[4][4], g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float a = J[i][0] * J[j][0];
#pragma unroll
      for (int k = 1; k < 10; ++k) a = a + J[i][k] * J[j][k];
      N[i][j] = a;
    }
    N[i][i] = N[i][i] + damping;
    float b = J[i][0] * res[0];
#pragma unroll
    for (int k = 1; k < 10; ++k) b = b + J[i][k] * res[k];
    g[i] = b;
  }

  // Cholesky (soa.chol_soa), then L y = -g, L^T dq = y
  float L[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = N[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float dj = sqrtf(clamp_min(s, kEps));
    L[j][j] = dj;
    const float inv_dj = 1.f / dj;
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {
      float t = N[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv_dj;
    }
  }
  float y[4], dq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 4; ++k) s = s - L[k][i] * dq[k];
    dq[i] = s / L[i][i];
  }

  // project the gauge out of the step, cap, renormalize
  const float dq_q = ((dq[0] * q[0] + dq[1] * q[1]) + dq[2] * q[2]) +
                     dq[3] * q[3];
#pragma unroll
  for (int s = 0; s < 4; ++s) dq[s] = dq[s] - dq_q * q[s];
  const float n = sqrtf(((dq[0] * dq[0] + dq[1] * dq[1]) + dq[2] * dq[2]) +
                        dq[3] * dq[3]);
  const float scale = clamp_max((1.f / clamp_min(n, kEps)) * step_cap, 1.f);
  float qn[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) qn[s] = q[s] + dq[s] * scale;
  const float nq = clamp_min(
      sqrtf(((qn[0] * qn[0] + qn[1] * qn[1]) + qn[2] * qn[2]) +
            qn[3] * qn[3]),
      kEps);
#pragma unroll
  for (int s = 0; s < 4; ++s) q[s] = qn[s] / nq;
}

// out[c, e*S + s, h] = entry e of start s's polished model of hypothesis h
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fivept_kernel(const float* __restrict__ g1,      // (C, 15, H)
              const float* __restrict__ g2,      // (C, 15, H)
              const float* __restrict__ starts,  // (S, 4)
              float* __restrict__ out,           // (C, 9 S, H)
              int H, int S, int n_iters, float step_cap, float damping) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.z;
  if (h >= H) return;
  float B[4][9];
  nullspace5(g1 + (size_t)c * 15 * H + h, g2 + (size_t)c * 15 * H + h, H, B);
  const int s_end = min(S, (blockIdx.y + 1) * kStartsPerThread);
#pragma unroll 1
  for (int s = blockIdx.y * kStartsPerThread; s < s_end; ++s) {
    float q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = starts[4 * s + i];
    for (int it = 0; it < n_iters; ++it) gn_step(B, q, step_cap, damping);
    float E[9];
    combine(B, q, E);
    float* o = out + ((size_t)c * 9 * S + s) * H + h;
#pragma unroll
    for (int e = 0; e < 9; ++e) o[(size_t)e * S * H] = E[e];
  }
}

}  // namespace

extern "C" int kmt_fivept_models(const void* g1, const void* g2,
                                 const void* starts, void* out, int C, int H,
                                 int S, int n_iters, float step_cap,
                                 float damping, void* stream) {
  if (C <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  dim3 grid((H + kThreads - 1) / kThreads,
            (S + kStartsPerThread - 1) / kStartsPerThread, C);
  fivept_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g1, (const float*)g2, (const float*)starts, (float*)out,
      H, S, n_iters, step_cap, damping);
  return (int)cudaGetLastError();
}
