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
// Like the TPU kernel, this one takes the distances as a matrix product:
// for q, t in {0,1}^256, d = |q| + |t| - 2 q.t, exact with int8 operands and
// int32 sums. The product runs on the int8 tensor cores (`wgmma`,
// m64n176k32, s8 x s8 -> s32, both operands K-major in shared memory).
//
// Bound on an H100: operations. Per chunk (1024 pairs, Kq = Kt = 704) the
// product is 2.6e11 int8 operations (0.131 ms at 1,979e12/s) against 55 MB
// of descriptors and results; the top-2 epilogue is 5.1e8 elements of about
// 4 integer instructions (0.12 ms at 64 per clock and SM). What the design
// does about it:
//  * One block per pair; it expands the pair's packed targets (32 bytes,
//    LSB first) once to {0,1} bytes in shared memory: a pass of 704
//    targets, 176 KB, in the no-swizzle K-major layout of `wgmma` (8-row x
//    16-byte core matrices; 128 bytes between core matrices along K, 2 KB
//    between 8-row groups). An invalid target's bits are zero, and so are
//    the rows of a pass past Kt. A thread issues all its loads of the pass
//    before it uses the first.
//  * Two warpgroups take 64-query tiles in turn, each with its own 16 KB
//    query tile, and each keeps two accumulator sets in flight: while it
//    takes the top-2 of one 176-target chunk, the product of the next runs
//    on the tensor cores. A warpgroup loads its next tile's packed rows
//    with cp.async while the current tile computes.
//  * Top-2 in registers with no ordered merge: every element gets a unique
//    key, distance * 2^b + column (b = the column bits). |q| is a per-row
//    constant and is added after the reduction. m2 = min(m2, max(m1,
//    key)), m1 = min(m1, key); the lanes that share a row merge with
//    __shfl_xor_sync. `min` on unique keys does not depend on order, so
//    the least key is the least distance at its first index and the
//    second-least key is the second-least distance, counting ties, as the
//    plain version defines them. An invalid target counts |t| = 512;
//    decoded distances are clamped to 512, so a row with no valid target
//    gives (512, 512, 0). Within one chunk a key is 16 bits, (|t| - 2 q.t
//    + 256) * 64 + the column's place among the thread's 44, and the keys
//    of a thread's two rows are folded as one pair (`chunk_top2_16`): two
//    IMAD and three 16x2 min/max for two elements, where 32-bit keys take
//    one IMAD and three IMNMX for each. The chunk's two least keys per row
//    then become 32-bit keys.
//  * More targets than one pass are staged pass by pass; a row's two keys
//    are kept in the outputs between passes and merged the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoMatch = 512;
constexpr int kP2Groups = 2;                  // consumer warpgroups
constexpr int kP2Threads = 128 * kP2Groups;
constexpr int kP2Rows = 64;                   // queries per tile (wgmma M)
constexpr int kP2N = 176;                     // targets per wgmma (N)
constexpr int kP2Pass = 4 * kP2N;             // targets staged per pass
constexpr int kCoreK = 128;                   // bytes between K core matrices
constexpr int kCoreMN = 2048;                 // bytes between 8-row groups
constexpr int kChunkBytes = kP2N / 8 * kCoreMN;  // one chunk of targets
constexpr int kKeyNone = 0x7fffffff;
// dynamic shared memory: targets, query tiles, column keys, packed query
// tiles (cp.async), query bit counts, target bit counts by half
constexpr int kSmB = 0;
constexpr int kSmA = kSmB + kP2Pass * 256;
constexpr int kSmCol = kSmA + kP2Groups * kP2Rows * 256;
constexpr int kSmPk = kSmCol + kP2Pass * 4;
constexpr int kSmPop = kSmPk + kP2Groups * kP2Rows * 32;
constexpr int kSmTpop = kSmPop + kP2Groups * 2 * kP2Rows * 4;
constexpr int kSmBytes = kSmTpop + 2 * kP2Pass * 4;
constexpr int kStageLoads = (2 * kP2Pass + kP2Threads - 1) / kP2Threads;

// the 4 low bits of n to the low bit of each byte
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return ((n & 0xfu) * 0x00204081u) & 0x01010101u;
}

// 16 packed bytes (bits of 16-byte core-matrix rows 0..7 along K) to {0,1}
// bytes at dst + cc * kCoreK, cc = 0..7
__device__ __forceinline__ void expand16(const uint4 v, unsigned char* dst) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
    const uint32_t h = w[cc >> 1] >> ((cc & 1) * 16);
    *reinterpret_cast<uint4*>(dst + cc * kCoreK) =
        make_uint4(spread4(h), spread4(h >> 4), spread4(h >> 8),
                   spread4(h >> 12));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `wgmma` shared-memory descriptor, no swizzle, K-major
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) |
         ((uint64_t)(kCoreK >> 4) << 16) | ((uint64_t)(kCoreMN >> 4) << 32);
}

#define KMT_R11(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7]),   \
      "+r"(d[i + 8]), "+r"(d[i + 9]), "+r"(d[i + 10])

// d (64 x 176 s32, this thread's 88) (+)= A (64 x 32 s8) B^T (176 x 32 s8)
__device__ __forceinline__ void wgmma_176(int d[88], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87}, "
      "%88, %89, p;\n}\n"
      : KMT_R11(0), KMT_R11(11), KMT_R11(22), KMT_R11(33), KMT_R11(44),
        KMT_R11(55), KMT_R11(66), KMT_R11(77)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef KMT_R11

// keep the compiler from moving reads or writes of r across the wgmma
// pipeline's fences
__device__ __forceinline__ void fence_regs(int r[88]) {
#pragma unroll
  for (int i = 0; i < 88; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void group_bar(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a row's least (m1) and second-least (m2) key so far, keys unique per
// column: merge in a sorted pair o1 < o2 of keys of other columns
__device__ __forceinline__ void top2_merge(int& m1, int& m2, int o1, int o2) {
  m2 = min(min(m2, o2), max(m1, o1));
  m1 = min(m1, o1);
}

// start one chunk's product: d = A (64 x 256) B^T (176 x 256), 8 k-steps
__device__ __forceinline__ void issue_chunk(int d[88], uint32_t a_addr,
                                            uint32_t b_addr) {
  fence_regs(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_176(d, gmma_desc(a_addr + ks * 2 * kCoreK),
              gmma_desc(b_addr + ks * 2 * kCoreK), ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending chunk products are in flight
template <int kPending>
__device__ __forceinline__ void wait_chunk(int d[88]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
  fence_regs(d);
}

__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a 16-bit chunk key -> the 32-bit key of its column (none past nt)
__device__ __forceinline__ int key32(uint32_t k, int col0, int bits) {
  const int v = (int)(k >> 6);
  return v == 1023 ? kKeyNone
                   : ((v - 256) << bits) + col0 + 8 * ((k & 63) >> 1) +
                         (k & 1);
}

// fold a chunk's products into the top-2 keys of this thread's two rows
// (m[0], m[1]: row warp*16 + lane/4, "a"; m[2], m[3]: 8 rows below, "b"),
// both rows at once. d[4j + v] is in column 8j + 2 (lane % 4) (+1 for odd
// v), row a for v < 2. Within the chunk a key is 16 bits, (|t| - 2 q.t +
// 256) * 64 + the column's place among the thread's 44 (unique, in column
// order), row a in the low and row b in the high half: key = base - (q.t_a
// + q.t_b * 2^16) * 128 (no borrow crosses: each half stays in [0, 2^16)),
// then min/max on both halves at once. The chunk's two least keys per row
// become 32-bit keys and are merged into m. cb points at the chunk's
// 16-bit key bases + 2 (lane % 4), col0 = its first column + 2 (lane % 4).
__device__ __forceinline__ void chunk_top2_16(const int d[88],
                                              const uint32_t* cb, int col0,
                                              int bits, int m[4]) {
  uint32_t p1 = 0xffffffffu, p2 = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < kP2N / 8; ++j) {
    const uint2 k2 = *reinterpret_cast<const uint2*>(cb + 8 * j);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint32_t key =
          (v ? k2.y : k2.x) -
          ((uint32_t)d[4 * j + v] + ((uint32_t)d[4 * j + 2 + v] << 16)) * 128u;
      p2 = min_u16x2(p2, max_u16x2(p1, key));
      p1 = min_u16x2(p1, key);
    }
  }
  top2_merge(m[0], m[1], key32(p1 & 0xffffu, col0, bits),
             key32(p2 & 0xffffu, col0, bits));
  top2_merge(m[2], m[3], key32(p1 >> 16, col0, bits),
             key32(p2 >> 16, col0, bits));
}

__global__ void __launch_bounds__(kP2Threads, 1)
pair_top2_kernel(const uint4* __restrict__ dq,       // (C, Kq, 2) uint4
                 const uint4* __restrict__ dt,       // (C, Kt, 2) uint4
                 const uint8_t* __restrict__ valid_t,  // (C, Kt)
                 int* __restrict__ d1_out, int* __restrict__ d2_out,
                 int* __restrict__ i1_out, int Kq, int Kt, int bits) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sB = smem + kSmB;
  uint32_t* s_col = reinterpret_cast<uint32_t*>(smem + kSmCol);
  int* s_tpop = reinterpret_cast<int*>(smem + kSmTpop);

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int group = tid >> 7, gt = tid & 127;
  const int warp = gt >> 5, lane = tid & 31;
  unsigned char* sA = smem + kSmA + group * (kP2Rows * 256);
  uint4* s_pk = reinterpret_cast<uint4*>(smem + kSmPk) + group * kP2Rows * 2;
  int* s_pop = reinterpret_cast<int*>(smem + kSmPop) + group * 2 * kP2Rows;
  const int n_tiles = (Kq + kP2Rows - 1) / kP2Rows;
  const uint4* qsrc = dq + (size_t)c * Kq * 2;
  const uint4* tsrc = dt + (size_t)c * Kt * 2;
  const uint8_t* vsrc = valid_t + (size_t)c * Kt;

  // cp.async of one tile's packed rows, 16 bytes a thread; rows past Kq
  // are zero-filled
  auto load_tile = [&](int tile) {
    const int q = tile * kP2Rows + (gt >> 1);
    const uint4* src = qsrc + (size_t)min(q, Kq - 1) * 2 + (gt & 1);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 "cp.async.commit_group;\n" ::"r"(smem_addr(s_pk + gt)),
                 "l"(src), "r"(q < Kq ? 16 : 0)
                 : "memory");
  };

  for (int t0 = 0; t0 == 0 || t0 < Kt; t0 += kP2Pass) {
    const int nt = min(kP2Pass, Kt - t0);
    const bool first = t0 == 0, last = t0 + kP2Pass >= Kt;
    if (group < n_tiles) load_tile(group);

    // stage the pass's targets (zero past nt and where invalid), all of a
    // thread's loads issued before the first is used, and the halves'
    // bit counts (an invalid target's add up to kNoMatch)
    {
      uint4 v[kStageLoads];
      bool ok[kStageLoads];
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int i = tid + u * kP2Threads;
        const int half = i >= kP2Pass, r = i - half * kP2Pass;
        const bool live = i < 2 * kP2Pass && r < nt;
        v[u] = live ? tsrc[(size_t)(t0 + r) * 2 + half]
                    : make_uint4(0, 0, 0, 0);
        ok[u] = live && vsrc[t0 + r];
      }
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int i = tid + u * kP2Threads;
        if (i >= 2 * kP2Pass) break;
        const int half = i >= kP2Pass, r = i - half * kP2Pass;
        const uint4 w = ok[u] ? v[u] : make_uint4(0, 0, 0, 0);
        expand16(w, sB + (r >> 3) * kCoreMN + (r & 7) * 16 +
                        half * 8 * kCoreK);
        s_tpop[i] = ok[u] ? __popc(w.x) + __popc(w.y) + __popc(w.z) +
                                __popc(w.w)
                          : (half ? 0 : kNoMatch);
      }
    }
    __syncthreads();
    // each column's 16-bit key base, in both halves: (|t| + 256) * 64 +
    // the column's place among the 44 a thread sees in one chunk; an
    // invalid target has |t| = kNoMatch, a column past nt the value 1023
    for (int r = tid; r < kP2Pass; r += kP2Threads) {
      const int pop = s_tpop[r] + s_tpop[kP2Pass + r];
      const int col = r % kP2N;
      const uint32_t k16 = ((r < nt ? pop + 256 : 1023) << 6) |
                           (2 * (col >> 3) + (col & 1));
      s_col[r] = k16 | (k16 << 16);
    }
    fence_async_proxy();
    __syncthreads();

    for (int tile = group; tile < n_tiles; tile += kP2Groups) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      group_bar(group);
      {  // expand the tile's queries and count their bits
        const int r = gt & (kP2Rows - 1), half = gt >> 6;
        const uint4 v = s_pk[2 * r + half];
        s_pop[half * kP2Rows + r] =
            __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        expand16(v, sA + (r >> 3) * kCoreMN + (r & 7) * 16 +
                        half * 8 * kCoreK);
      }
      fence_async_proxy();
      group_bar(group);
      if (tile + kP2Groups < n_tiles) load_tile(tile + kP2Groups);

      int m[4] = {kKeyNone, kKeyNone, kKeyNone, kKeyNone};
      const uint32_t a_addr = smem_addr(sA);
      const uint32_t b_addr = smem_addr(sB);
      // fold chunk ch's products (in d) into m
      auto fold = [&](const int* d, int ch) {
        const int off = ch * kP2N + 2 * (lane & 3);
        chunk_top2_16(d, s_col + off, t0 + off, bits, m);
      };
      // two accumulator sets: chunk ch + 1's product runs on the tensor
      // cores while this warpgroup takes the top-2 of chunk ch. A pass is
      // always 4 chunks (zero targets past nt), so the sequence has no
      // branch; with a branch on the chunk count ptxas serializes the
      // products (C7514)
      int d0[88], d1[88];
      issue_chunk(d0, a_addr, b_addr);
      issue_chunk(d1, a_addr, b_addr + kChunkBytes);
      wait_chunk<1>(d0);
      fold(d0, 0);
      issue_chunk(d0, a_addr, b_addr + 2 * kChunkBytes);
      wait_chunk<1>(d1);
      fold(d1, 1);
      issue_chunk(d1, a_addr, b_addr + 3 * kChunkBytes);
      wait_chunk<1>(d0);
      fold(d0, 2);
      wait_chunk<0>(d1);
      fold(d1, 3);
      int m1a = m[0], m2a = m[1], m1b = m[2], m2b = m[3];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        top2_merge(m1a, m2a, __shfl_xor_sync(0xffffffffu, m1a, o),
                   __shfl_xor_sync(0xffffffffu, m2a, o));
        top2_merge(m1b, m2b, __shfl_xor_sync(0xffffffffu, m1b, o),
                   __shfl_xor_sync(0xffffffffu, m2b, o));
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + (lane >> 2) + 8 * h;
          const int q = tile * kP2Rows + r;
          int m1 = h ? m1b : m1a, m2 = h ? m2b : m2a;
          if (q >= Kq) continue;
          const size_t o = (size_t)c * Kq + q;
          if (!first) top2_merge(m1, m2, d1_out[o], d2_out[o]);
          if (last) {
            const int pq = s_pop[r] + s_pop[kP2Rows + r];
            d1_out[o] = min(kNoMatch, (m1 >> bits) + pq);
            d2_out[o] = min(kNoMatch, (m2 >> bits) + pq);
            i1_out[o] = m1 == kKeyNone ? 0 : m1 & ((1 << bits) - 1);
          } else {
            d1_out[o] = m1;
            d2_out[o] = m2;
          }
        }
      }
      group_bar(group);
    }
    __syncthreads();
  }
}

}  // namespace

// desc_q (C, Kq, 32) u8, desc_t (C, Kt, 32) u8 (both 16-byte aligned),
// valid_t (C, Kt) u8/bool -> d1, d2, i1 (C, Kq) i32. Kt <= 2^21 (the
// column bits of the keys).
extern "C" int kmt_pair_top2(const void* desc_q, const void* desc_t,
                             const void* valid_t, void* d1, void* d2,
                             void* i1, int C, int Kq, int Kt, void* stream) {
  if (C <= 0 || Kq <= 0) return (int)cudaGetLastError();
  int bits = 1;
  while (bits < 21 && (1 << bits) < Kt) ++bits;
  if (Kt < 0 || Kt > (1 << bits)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmBytes);
  if (err != cudaSuccess) return (int)err;
  pair_top2_kernel<<<C, kP2Threads, kSmBytes, (cudaStream_t)stream>>>(
      (const uint4*)desc_q, (const uint4*)desc_t, (const uint8_t*)valid_t,
      (int*)d1, (int*)d2, (int*)i1, Kq, Kt, bits);
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
// Here, as in K1, the distances come from an int8 product on the tensor
// cores (`wgmma` m64n176k32, s8 x s8 -> s32), with the queries as A and the
// database streamed through B. A query is stored as 2q - 1 (bytes 1 or -1)
// and a target as -t (bytes 0 or -1), so A'.B = |t| - 2 q.t and d = |q| +
// A'.B: the product needs no bit count of the targets, and |q| is added
// once at the end.
//
// Bound on an H100: operations. At Kq = 704, Kt = 4.3 M the product is
// 1.56e15 int8 operations (0.79 ms at 1,979e12/s), the database 2.2 GB of
// bf16 read once (0.66 ms at 3.35 TB/s), the top-2 over the product 3.05e9
// elements at 2.5 integer instructions each (0.46 ms). The three have to
// overlap. What the design does about it:
//  * A block holds up to 704 queries, 11 tiles of 64 rows in the no-swizzle
//    K-major layout of `wgmma` (176 KB), staged once, and walks one
//    contiguous split of the database in chunks of 176 rows through a
//    single 45 KB B stage; one block on each SM, so the database is read
//    from device memory once. A chunk's rows come in as bf16 (16 bytes, 8
//    values, a load) and are narrowed by the threads to bytes 0 / -1 with
//    the rule of the plain version, (h & 0x7fff) != 0 (5 instructions for
//    4 values); TMA cannot convert. A warp loads one 32-byte k-step of 8
//    rows at a time, so its 8-byte stores fill 256 contiguous bytes of the
//    stage (no bank conflict).
//  * Loads run ahead: the next chunk's rows are loaded into registers in
//    two halves while the current chunk's products run, each narrowed (16
//    bytes -> 8) four products later, between a product's issue and its
//    wait, so that a late load stalls a warp that waits anyway, and written
//    to the stage once every product of the current chunk is done.
//  * Two warpgroups take the tiles in turn (even tiles, odd tiles), each
//    with one accumulator set: a warpgroup issues its product only after
//    the other has issued its own (a pair of named barriers), so the tensor
//    cores run one warpgroup's product while the other takes its top-2.
//    With an odd tile count (11 at 704 queries) the last tile is shared:
//    the two take it in turn, chunk by chunk, so the turns alternate across
//    chunks too, and its fold waits until the next chunk is staged, while
//    the other warpgroup's first product of that chunk runs.
//  * Top-2 by unique keys, as in K1: within a chunk a 16-bit key per
//    element, (A'.B + 256) * 64 + the column's place among the thread's 44,
//    two rows folded at once with 16x2 min/max (2 IMAD and 3 VIMNMX for two
//    elements); the chunk's two least per row become 32-bit keys, (A'.B +
//    256) << 22 | the column within the split, kept in registers across the
//    whole split. Columns past the split's end carry the value 1023 (no
//    target). `min` over unique keys does not depend on order: the least
//    key is the least distance at its first index, the second-least the
//    second-least distance counting ties.
//
// The grid's x axis is the query groups of 704, its y axis contiguous
// splits of the target axis, each at most 2^22 rows (the keys' column
// bits). Each split writes a partial (d1, d2, i1); a second kernel merges
// the splits in split order, replacing i1 only on a strict `<`, so i1 is
// the first index of the least distance and d2 keeps multiplicity (d2 ==
// d1 when the least occurs twice), as the JAX merge min(max(od1, nd1),
// min(od2, nd2)) gives.

namespace {

constexpr int kT2Threads = 256;                  // two warpgroups
constexpr int kT2N = kP2N;                       // targets per chunk
constexpr int kT2Tiles = 11;                     // query tiles of a block
constexpr int kT2Queries = kT2Tiles * kP2Rows;   // 704
constexpr int kT2Own = kT2Tiles / 2;            // tiles of a warpgroup
constexpr int kT2TileBytes = kP2Rows * 256;
constexpr int kT2StageBytes = kT2N * 256;
constexpr int kT2Half = kT2N * 32 / kT2Threads / 2;  // uint4 loads a half
constexpr int kT2ColBits = 22;
constexpr uint32_t kT2KeyNone = 0xffffffffu;
constexpr int kT2None = 0x3fffffff;              // no target seen
// 16-bit chunk keys: value field of a live column (A'.B + 256 at A'.B = 0
// is 256, i.e. 16384 after the shift) and of a column past the end (1023)
constexpr uint32_t kT2Live = 256u << 6, kT2Dead = 1023u << 6;

static_assert(kT2N * 32 == 2 * kT2Half * kT2Threads, "chunk loads");
static_assert(kT2N % 8 == 0 && 2 * kT2Half * 8 == kT2N, "row groups");
static_assert(kT2Own > 4, "the slots that narrow a chunk");

// query tiles a block stages for Kq queries (all kT2Tiles once a launch
// has more than one block of queries)
__host__ __device__ constexpr int t2_tiles(int Kq) {
  return Kq >= kT2Queries ? kT2Tiles : (Kq + kP2Rows - 1) / kP2Rows;
}

__host__ __device__ constexpr int t2_smem_bytes(int tiles) {
  return tiles * kT2TileBytes + kT2StageBytes + tiles * kP2Rows * 4;
}

// byte i = -1 where (value i & 0x7fff) != 0, else 0, for the 4 bf16 values
// of w0 (0, 1) and w1 (2, 3): (h | 0x8000) - 1 has bit 15 set iff h &
// 0x7fff != 0, with no borrow out of a 16-bit half, and `prmt` spreads that
// bit of each half over its byte (a selector nibble with its msb set
// replicates the sign of the byte it picks)
__device__ __forceinline__ uint32_t neg_nonzero4(uint32_t w0, uint32_t w1) {
  const uint32_t s0 = (w0 | 0x80008000u) - 0x00010001u;
  const uint32_t s1 = (w1 | 0x80008000u) - 0x00010001u;
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xfdb9;" : "=r"(r) : "r"(s0), "r"(s1));
  return r;
}

__device__ __forceinline__ uint2 neg_nonzero8(const uint4 v) {
  return make_uint2(neg_nonzero4(v.x, v.y), neg_nonzero4(v.z, v.w));
}

__device__ __forceinline__ void top2_merge_u(uint32_t& m1, uint32_t& m2,
                                             uint32_t o1, uint32_t o2) {
  m2 = min(min(m2, o2), max(m1, o1));
  m1 = min(m1, o1);
}

// a 16-bit chunk key -> the 32-bit key of its column within the split
// (col0: the split column of the thread's first in the chunk)
__device__ __forceinline__ uint32_t t2_key32(uint32_t k, int col0) {
  const uint32_t v = k >> 6;
  return v == 1023u ? kT2KeyNone
                    : (v << kT2ColBits) + (uint32_t)col0 +
                          8u * ((k & 63u) >> 1) + (k & 1u);
}

// fold one chunk's products into the running keys of this thread's two
// rows (m[0] < m[1]: row warp*16 + lane/4; m[2] < m[3]: 8 rows below).
// d[4j + v] is A'.B of column 8j + 2 (lane % 4) + v, row a for v < 2 (row
// b 2 further). Both rows' 16-bit keys in one word: (A'.B_a + 65536
// A'.B_b) * 64 + base, each half in [0, 2^16) for |A'.B| <= 256. kRagged:
// columns at or past nt are past the split's end (zero rows, A'.B = 0)
// and get the value 1023.
template <bool kRagged>
__device__ __forceinline__ void t2_fold(const int d[88], int col0, int nt,
                                        int lane, uint32_t m[4]) {
  uint32_t p1 = 0xffffffffu, p2 = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < kT2N / 8; ++j) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      uint32_t base = (kT2Live + 2 * j + v) * 0x10001u;
      if (kRagged && 8 * j + 2 * (lane & 3) + v >= nt)
        base += (kT2Dead - kT2Live) * 0x10001u;
      const uint32_t key =
          ((uint32_t)d[4 * j + 2 + v] * 65536u + (uint32_t)d[4 * j + v]) *
              64u + base;
      p2 = min_u16x2(p2, max_u16x2(p1, key));
      p1 = min_u16x2(p1, key);
    }
  }
  top2_merge_u(m[0], m[1], t2_key32(p1 & 0xffffu, col0),
               t2_key32(p2 & 0xffffu, col0));
  top2_merge_u(m[2], m[3], t2_key32(p1 >> 16, col0),
               t2_key32(p2 >> 16, col0));
}

__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kT2Threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kT2Threads)
               : "memory");
}

__device__ __forceinline__ int t2_decode(uint32_t key, int pq) {
  return key == kT2KeyNone ? kT2None : (int)(key >> kT2ColBits) - 256 + pq;
}

__global__ void __launch_bounds__(kT2Threads, 1)
hamming_top2_kernel(const uint4* __restrict__ bq,   // (Kq, 32) uint4
                    const uint4* __restrict__ bt,   // (Kt, 32) uint4
                    int* __restrict__ part,         // (3, S, Kq)
                    int Kq, int Kt, int rows_per_split, int tiles_alloc) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sA = smem;
  unsigned char* sB = smem + tiles_alloc * kT2TileBytes;
  int* s_pop = reinterpret_cast<int*>(sB + kT2StageBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = tid >> 7, gwarp = warp & 3;
  const int q0 = blockIdx.x * kT2Queries;
  const int nq = min(kT2Queries, Kq - q0);
  const int n_tiles = (nq + kP2Rows - 1) / kP2Rows;
  const int split = blockIdx.y, S = gridDim.y;
  const int lo = split * rows_per_split;
  const int hi = min(Kt, lo + rows_per_split);
  const int n_chunks = (hi - lo + kT2N - 1) / kT2N;

  // the queries as 2q - 1 bytes in the A layout (rows past nq zero) and |q|;
  // warp w takes rows w, w + 8, ..., lane l bytes 8l .. 8l + 7 of a row
  for (int r = warp; r < n_tiles * kP2Rows; r += kT2Threads / 32) {
    const bool live = r < nq;
    const uint2 f = neg_nonzero8(live ? bq[(size_t)(q0 + r) * 32 + lane]
                                      : make_uint4(0, 0, 0, 0));
    const uint2 a = live ? make_uint2(~f.x | 0x01010101u,
                                      ~f.y | 0x01010101u)
                         : make_uint2(0, 0);
    *reinterpret_cast<uint2*>(sA + (r >> 6) * kT2TileBytes +
                              ((r & 63) >> 3) * kCoreMN +
                              (lane >> 1) * kCoreK + (r & 7) * 16 +
                              (lane & 1) * 8) = a;
    const int pop = __reduce_add_sync(
        0xffffffffu, __popc(f.x & 0x01010101u) + __popc(f.y & 0x01010101u));
    if (lane == 0) s_pop[r] = pop;
  }

  // chunk loads: in row group g (8 rows) this thread takes row g*8 +
  // lane%8, bytes 16 (4 warp + lane/8) .. +15 of its 512 (k-step `warp`)
  const uint4* src = bt + (size_t)(lo + (lane & 7)) * 32 + 4 * warp +
                     (lane >> 3);
  const int row_lim = hi - lo - (lane & 7);
  unsigned char* dst = sB + (2 * warp + (lane >> 4)) * kCoreK +
                       (lane & 7) * 16 + ((lane >> 3) & 1) * 8;
  uint4 raw[kT2Half];
  uint2 cva[kT2Half], cvb[kT2Half];
  // half h of chunk c into raw (zero past the split's end, not loaded)
  auto load_half = [&](int c, int h) {
#pragma unroll
    for (int u = 0; u < kT2Half; ++u) {
      const int r = c * kT2N + (h * kT2Half + u) * 8;
      raw[u] = r < row_lim ? __ldcs(src + (size_t)r * 32)
                           : make_uint4(0, 0, 0, 0);
    }
  };
  auto narrow = [&](uint2* cv) {
#pragma unroll
    for (int u = 0; u < kT2Half; ++u) cv[u] = neg_nonzero8(raw[u]);
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < kT2Half; ++u) {
      *reinterpret_cast<uint2*>(dst + u * kCoreMN) = cva[u];
      *reinterpret_cast<uint2*>(dst + (kT2Half + u) * kCoreMN) = cvb[u];
    }
  };

  load_half(0, 0);
  narrow(cva);
  load_half(0, 1);
  narrow(cvb);
  store();
  fence_async_proxy();
  __syncthreads();

  // running keys: m[i] of own tile group + 2i, m[kT2Own] of the shared tile
  uint32_t m[kT2Own + 1][4];
#pragma unroll
  for (int i = 0; i <= kT2Own; ++i)
    m[i][0] = m[i][1] = m[i][2] = m[i][3] = kT2KeyNone;
  const uint32_t a_addr = smem_addr(sA), b_addr = smem_addr(sB);
  // tiles t < n_own belong to warpgroup t % 2; with an odd count the last
  // is shared: the warpgroup that issues a chunk's first product issues its
  // last, on the shared tile, and the two take turns chunk by chunk
  const int n_own = n_tiles & ~1;
  const bool odd = n_tiles & 1;
  int d[88];

  for (int c = 0; c < n_chunks; ++c) {
    const int nt = min(kT2N, hi - lo - c * kT2N);
    const int col0 = c * kT2N + 2 * (lane & 3);
    const bool first = group == (odd ? (c & 1) : 0);
    auto fold = [&](uint32_t* mi) {
      if (nt == kT2N)
        t2_fold<false>(d, col0, nt, lane, mi);
      else
        t2_fold<true>(d, col0, nt, lane, mi);
    };
    // work of slot i that does not touch the product, done while this
    // warpgroup's product runs (or in its place where the slot has no
    // tile): the next chunk's first half loaded at slot 0, narrowed at
    // slot 2, where the second half is loaded, narrowed at slot 4; four
    // products run between a load and its use
    auto side = [&](int i) {
      if (i == 0) {
        load_half(c + 1, 0);
      } else if (i == 2) {
        narrow(cva);
        load_half(c + 1, 1);
      } else if (i == 4) {
        narrow(cvb);
      }
    };
    // products go to the tensor cores in turn, position p = 0, 1, ... of
    // the chunk: wait until the other warpgroup has issued p - 1, let it
    // issue p + 1 after this
#pragma unroll
    for (int i = 0; i < kT2Own; ++i) {
      const int t = group + 2 * i;
      if (t < n_own) {
        const int p = 2 * i + (first ? 0 : 1);
        if (p > 0) named_bar_sync(1 + group);
        issue_chunk(d, a_addr + t * kT2TileBytes, b_addr);
        if (p + 1 < n_tiles) named_bar_arrive(2 - group);
        side(i);
        wait_chunk<0>(d);
        fold(m[i]);
      } else {
        side(i);
      }
    }
    // the shared tile, last; its fold waits until the next chunk is
    // staged, so that the other warpgroup's first product runs meanwhile
    const bool shared = odd && first;
    if (shared) {
      if (n_tiles > 1) named_bar_sync(1 + group);
      issue_chunk(d, a_addr + n_own * kT2TileBytes, b_addr);
      wait_chunk<0>(d);
    }
    __syncthreads();  // every product of chunk c is done
    if (c + 1 < n_chunks) {
      store();
      fence_async_proxy();
    }
    __syncthreads();
    if (shared) fold(m[kT2Own]);
  }

  // the shared tile's keys of warpgroup 1 merged into warpgroup 0's (the
  // same rows in the same lanes), through the stage
  if (odd) {
    uint4* s_keys = reinterpret_cast<uint4*>(sB);
    if (group == 1)
      s_keys[tid - 128] = make_uint4(m[kT2Own][0], m[kT2Own][1],
                                     m[kT2Own][2], m[kT2Own][3]);
    __syncthreads();
    if (group == 0) {
      const uint4 o = s_keys[tid];
      top2_merge_u(m[kT2Own][0], m[kT2Own][1], o.x, o.y);
      top2_merge_u(m[kT2Own][2], m[kT2Own][3], o.z, o.w);
    }
  }
  // merge the 4 lanes of a row; write the split's partial result
  auto emit = [&](const uint32_t* mi, int t) {
    uint32_t m1a = mi[0], m2a = mi[1], m1b = mi[2], m2b = mi[3];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      top2_merge_u(m1a, m2a, __shfl_xor_sync(0xffffffffu, m1a, o),
                   __shfl_xor_sync(0xffffffffu, m2a, o));
      top2_merge_u(m1b, m2b, __shfl_xor_sync(0xffffffffu, m1b, o),
                   __shfl_xor_sync(0xffffffffu, m2b, o));
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t * kP2Rows + gwarp * 16 + (lane >> 2) + 8 * h;
        if (r >= nq) continue;
        const uint32_t m1 = h ? m1b : m1a, m2 = h ? m2b : m2a;
        const size_t o = (size_t)split * Kq + q0 + r;
        part[o] = t2_decode(m1, s_pop[r]);
        part[(size_t)S * Kq + o] = t2_decode(m2, s_pop[r]);
        part[(size_t)2 * S * Kq + o] =
            m1 == kT2KeyNone ? -1 : lo + (int)(m1 & ((1u << kT2ColBits) - 1));
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kT2Own; ++i)
    if (group + 2 * i < n_own) emit(m[i], group + 2 * i);
  if (odd && group == 0) emit(m[kT2Own], n_own);
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

// Dynamic shared memory of the DB-wide kernel for Kq queries (host only).
extern "C" int kmt_hamming_top2_smem(int Kq) {
  return t2_smem_bytes(t2_tiles(Kq));
}

// bits_q (Kq, 256) bf16, bits_t (Kt, 256) bf16 (16-byte aligned), part
// (3, S, Kq) i32 scratch -> d1, d2 (Kq,) f32, i1 (Kq,) i32. Targets
// [s * rows_per_split, (s + 1) * rows_per_split) form split s < S; every
// split holds a target and at most 2^22 (the keys' column bits).
extern "C" int kmt_hamming_top2(const void* bits_q, const void* bits_t,
                                void* part, void* d1, void* d2, void* i1,
                                int Kq, int Kt, int rows_per_split, int S,
                                void* stream) {
  if (Kq <= 0 || Kt <= 0 || S <= 0 || S > 65535 || rows_per_split <= 0 ||
      rows_per_split > (1 << kT2ColBits) ||
      (long long)(S - 1) * rows_per_split >= Kt ||
      (long long)S * rows_per_split < Kt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = t2_tiles(Kq);
  const int smem = t2_smem_bytes(tiles);
  cudaError_t err = cudaFuncSetAttribute(
      hamming_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Kq + kT2Queries - 1) / kT2Queries, S);
  hamming_top2_kernel<<<grid, kT2Threads, smem, st>>>(
      (const uint4*)bits_q, (const uint4*)bits_t, (int*)part, Kq, Kt,
      rows_per_split, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hamming_top2_merge_kernel<<<(Kq + 127) / 128, 128, 0, st>>>(
      (const int*)part, (float*)d1, (float*)d2, (int*)i1, Kq, S);
  return (int)cudaGetLastError();
}
