// Causal flash attention (prefill) for Hopper (sm_90a), on the tensor cores.
//
// The compiler's CTE fusion taken to a kernel: the Q K^T join, the row
// max / row sum aggregations of the softmax and the V join run in one pass,
// so the T x S score relation never reaches device memory.
//
//   q [B, H, T, D], k/v [B, Hkv, S, D] -> o [B, H, T, D]
//
// Each tensor comes with its (b, h, t) strides and a unit inner stride, so
// the executor's [T, H, D] and [S, Hkv, D] tables pass as views.  Query
// head h reads key/value head h / (H / Hkv); with Hkv = H this is the TPU
// kernel's signature.  The causal mask places query row t at position
// t + q_off (it sees keys s <= t + q_off), so T < S is legal: at q_off = 0
// the prefill over a cache_len-deep cache, at q_off = the cached prefix's
// length the suffix prefill of the prefix cache (the graph's mask
// tp <= t + :cache_position; the TPU kernel has only q_off = 0).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel and
// flash_attention).  There the grid is (B*H, T/bq, S/bk) with the KV tiles
// as the sequential inner axis and the running max / sum / accumulator in
// VMEM scratch; it asserts T % bq == 0 and S % bk == 0.  Here a block loops
// over the KV tiles itself with the state in registers; ragged T and S are
// masked in the kernel, since prompts have any length, and KV tiles past
// the block's last query position (causal) or past S are never loaded.
//
// Bound: the products take 4 * D flops per (query, live key) pair.  At a
// 512-token prompt that is above the balance point of the units the kernel
// uses (3xTF32 on the tensor cores: 495 / 3 = 165 TFLOP/s against 3.35
// TB/s), so the bound is the tensor cores'; at 32- and 64-token prompts
// the work is a few microseconds of one SM's, and latency sets the launch.
// A suffix prefill over a long cached prefix (32 rows at q_off = 448) is
// latency-bound too: 8 to 24 blocks, each streaming 15 or 16 K/V tiles in
// sequence; splitting the KV range over blocks would fill the card.
// Design:
//
// - Each warp owns 16 query rows of one head: the M of mma.sync
//   m16n8k8 (tf32) / m16n8k16 (bf16).  A block has 1, 2 or 4 warps
//   (blockDim), spanning `heads` query heads that read one KV head (one
//   staged K/V tile serves them all) and then consecutive query tiles; the
//   caller's plan (kernels/flash_attention.py, _plan) picks four unless
//   that leaves a block's query tiles past T.  Blocks run the latest
//   query tiles first, which hold the most causal work; where SMs run
//   several blocks each (`balance`), each block takes two row groups, the
//   x-th latest and the x-th earliest, so that blocks hold equal work
//   (row group i reads about q_off + (i + 1) * rows keys, so the two
//   groups of a pair read the same sum at any q_off).
// - K/V tiles of BK rows (32 in f32, 64 in bf16) are copied by 16-byte
//   cp.async into a double buffer in shared memory (a scalar path in the
//   same kernel takes views that are not 16-byte aligned), one tile in
//   flight while the last is used, two __syncthreads per tile.  Rows are
//   padded so that each fragment read of a warp falls in distinct banks.
// - Q is read once: bf16's A fragments stay in registers for the whole
//   loop, f32's 16 rows a warp in shared memory (beside the f32 O
//   accumulator they would spill registers at D = 128).  S = Q K^T and
//   O += P V accumulate in f32 fragments.  The online softmax runs on the
//   S fragments (row max and sum over the four lanes of a quad by
//   shuffles).  P reaches the A-fragment layout in registers: in bf16 the
//   m16n8k16 A layout matches two S tiles; in tf32 the k index of a P V
//   step is permuted (A column t <-> key 2t, t + 4 <-> key 2t + 1, and V's
//   rows read to match), and so is Q K^T's, so that K's fragments are one
//   8-byte load.
// - f32 runs as 3xTF32: x = hi + lo with hi = tf32(x) and lo = x - hi,
//   and a b = hi_a hi_b + hi_a lo_b + lo_a hi_b in the f32 accumulator
//   (CUTLASS's "big + small" split: integer ops, no conversion
//   instruction).  tf32 keeps 11 significant bits, so |lo| <= 2^-11 |x|,
//   the tensor core's truncation of lo costs at most 2^-10 |lo| <= 2^-21
//   |x|, and the dropped lo_a lo_b is at most 2^-22 |a b|: each product is
//   within about 2^-19 = 2e-6 of its f32 value, where a single TF32 product
//   is off by up to about 2^-10 = 1e-3, past the 1e-4 limit against the f32
//   plain version.  (The rule that keeps TF32 off for f32 parity is about
//   single-pass TF32 products.)
// - bf16 multiplies bf16 operands with f32 accumulation; p is rounded to
//   bf16 for the P V product (the A fragment) while the running sum uses
//   the unrounded p, as in the TPU kernel.
// - The softmax runs in log2 units (scores times log2(e), exp2).
//
// The dynamic shared memory attribute is set once per kernel and device.
// A launch with a causal offset runs a second build of the kernel (kOffset
// below).

#include <atomic>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpRows = 16;  // query rows of a warp: the mma's M
constexpr int kMaxWarps = 4;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x = hi + lo: hi is x rounded to tf32 (half an ulp added, the low 13
// mantissa bits cleared), lo = x - hi exactly in f32, of which the tensor
// core reads the tf32 part (it ignores the low 13 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// two bf16 in one register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment split into tf32 halves, once for all the n tiles it meets
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}

// c += a b as 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory geometry for element type T and head dim D: K's rows are
// zero-padded to the mma's K depth KS.  f32: K is read as 8-byte pairs
// (row stride = 8 or 24 mod 32 words), V as words two rows apart (2 LDV = 8
// mod 32); bf16: K as words (LDK / 2 = 4 mod 8 words ...), V by ldmatrix
// (row stride 16 mod 128 bytes).  Rows stay 16-byte aligned for cp.async.
template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int KS = kF32 ? 8 : 16;
  static constexpr int DK = (D + KS - 1) / KS * KS;
  static constexpr int LDK = kF32 ? (DK == 8 ? 24 : DK + 8) : DK + 8;
  static constexpr int LDV = kF32 ? D + 4 : D + 8;
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  static constexpr int CPR = D / EPC;  // 16-byte chunks of a row
  static_assert(D % 8 == 0 && D % EPC == 0, "head dim");
};

// the K/V double buffer, then (f32) each warp's 16 rows of Q
template <typename T, int D, int BK>
constexpr size_t smem_bytes(int warps) {
  return (2 * static_cast<size_t>(BK) * (Tile<T, D>::LDK + Tile<T, D>::LDV) +
          (Tile<T, D>::kF32 ? static_cast<size_t>(warps) * kWarpRows *
                                  Tile<T, D>::LDK
                            : 0)) *
         sizeof(T);
}

// kOffset: the launch has a causal offset.  The kernel is built both ways
// because a runtime offset in the causal bounds made ptxas leave the
// dependent mma chains of Q K^T unfilled (NOPs between them), and every
// K/V tile about 1.6x slower on an H100, cold prefills included; built
// without it, an offset-0 launch runs the code it ran before the offset.
template <typename T, int D, int BK, bool kOffset>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Hkv, int T_, int S, int causal, int q_offset,
                       int heads,
                       int balance, int vec,
                       long long sqb, long long sqh, long long sqt,
                       long long skb, long long skh, long long sks,
                       long long svb, long long svh, long long svs,
                       long long sob, long long soh, long long sot,
                       float scale) {
  using Tl = Tile<T, D>;
  const int q_off = kOffset ? q_offset : 0;
  constexpr bool kF32 = Tl::kF32;
  constexpr int DK = Tl::DK, LDK = Tl::LDK, LDV = Tl::LDV;
  constexpr int EPC = Tl::EPC, CPR = Tl::CPR;
  constexpr int NS = BK / 8;  // S tiles of a KV tile (n = 8)
  constexpr int NO = D / 8;   // O tiles (n = 8)
  static_assert(BK % 16 == 0, "KV tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Ks = reinterpret_cast<T*>(smem_raw);  // [2][BK][LDK]
  T* const Vs = Ks + 2 * BK * LDK;               // [2][BK][LDV]
  T* const Qs = Vs + 2 * BK * LDV;               // f32: [warps][16][LDK]

  const int nthr = blockDim.x, tid = threadIdx.x;
  const float scale2 = scale * 1.4426950408889634f;  // softmax in log2 units
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma groupID, thread in group
  const int g = H / Hkv, ng = g / heads;
  const int rows = kWarpRows * (nthr / 32) / heads;
  const int y = blockIdx.y;
  const int hk = (y / ng) % Hkv, b = y / (ng * Hkv);
  const int h = hk * g + (y % ng) * heads + warp % heads;

  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  const T zero = from_f32<T>(0.f);
  if constexpr (DK > D) {  // K's padding columns stay zero
    for (int i = tid; i < 2 * BK; i += nthr)
#pragma unroll
      for (int c = D; c < DK; ++c) Ks[i * LDK + c] = zero;
  }

  auto load_tile = [&](int stage, int k0) {
    T* ks = Ks + stage * BK * LDK;
    T* vs = Vs + stage * BK * LDV;
    for (int c = tid; c < 2 * BK * CPR; c += nthr) {
      const bool is_v = c >= BK * CPR;
      const int cc = is_v ? c - BK * CPR : c;
      const int row = cc / CPR, ch = cc - row * CPR;
      const int key = k0 + row;
      T* dst = (is_v ? vs + row * LDV : ks + row * LDK) + ch * EPC;
      const T* base = is_v ? vb : kb;
      const T* src = base + key * (is_v ? svs : sks) + ch * EPC;
      if (vec) {
        cp_async16(dst, key < S ? src : base, key < S ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) dst[e] = key < S ? src[e] : zero;
      }
    }
  };

  // Each block takes one group of query rows, or with `balance` two: the
  // x-th latest and the x-th earliest, so that every block of a causal
  // prompt holds about the same number of KV tiles.
  const int nqb = (T_ + rows - 1) / rows;
  const int x = blockIdx.x;
  const int passes = balance && 2 * x + 1 < nqb ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const int q0 = (pass == 0 ? nqb - 1 - x : x) * rows;
    const int q0w = q0 + (warp / heads) * kWarpRows;
    const bool warp_live = q0w < T_;
    const int q_last = min(q0 + rows, T_) - 1;
    const int kv_end = causal ? min(S, q_last + q_off + 1) : S;
    const int n_tiles = (kv_end + BK - 1) / BK;

    // Q's A fragments: rows r0 = q0w + gid and r0 + 8
    const int r0 = q0w + gid, r1 = r0 + 8;
    const T* qb = q + b * sqb + h * sqh;
    auto qval = [&](int row, int col) {
      return row < T_ && col < D ? to_f32(qb[row * sqt + col]) : 0.f;
    };
    // f32: the warp's 16 rows in shared memory (in registers they would
    // spill at D = 128), read as A fragments with k step kk's column t <->
    // dim 8 kk + 2t, t + 4 <-> 8 kk + 2t + 1; bf16: the A fragments in
    // registers
    float* const qs = reinterpret_cast<float*>(Qs) + warp * kWarpRows * LDK;
    uint32_t qh[kF32 ? 1 : DK / 16][4];
    if constexpr (kF32) {
      // 32 loads a lane in flight (a loop of one load each would wait on
      // every one)
      constexpr int kPer = kWarpRows * DK / 32;
      constexpr int kBatch = kPer < 32 ? kPer : 32;
#pragma unroll 1
      for (int j0 = 0; j0 < kPer; j0 += kBatch) {
        float tmp[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = lane + 32 * (j0 + j);
          tmp[j] = qval(q0w + i / DK, i % DK);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = lane + 32 * (j0 + j);
          qs[(i / DK) * LDK + i % DK] = tmp[j];
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int c = 16 * kk + 2 * tig;
        qh[kk][0] = pack_bf16(qval(r0, c), qval(r0, c + 1));
        qh[kk][1] = pack_bf16(qval(r1, c), qval(r1, c + 1));
        qh[kk][2] = pack_bf16(qval(r0, c + 8), qval(r0, c + 9));
        qh[kk][3] = pack_bf16(qval(r1, c + 8), qval(r1, c + 9));
      }
    }

    float oacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's

    if (n_tiles > 0) load_tile(0, 0);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      if (it + 1 < n_tiles) load_tile((it + 1) & 1, (it + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();  // tile it has landed
      __syncthreads();
      const int k0 = it * BK;
      if (warp_live && (!causal || k0 <= q0w + kWarpRows - 1 + q_off)) {
        const T* ks = Ks + (it & 1) * BK * LDK;
        const T* vs = Vs + (it & 1) * BK * LDV;

        // S = Q K^T for this warp's 16 rows and the tile's BK keys
        float sacc[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sacc[j][i] = 0.f;
        if constexpr (kF32) {
#pragma unroll
          for (int kk = 0; kk < DK / 8; ++kk) {
            const float2 qa = *reinterpret_cast<const float2*>(
                qs + gid * LDK + 8 * kk + 2 * tig);
            const float2 qb8 = *reinterpret_cast<const float2*>(
                qs + (gid + 8) * LDK + 8 * kk + 2 * tig);
            const float qf[4] = {qa.x, qb8.x, qa.y, qb8.y};
            uint32_t ah[4], al[4];
            split_a(qf, ah, al);
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              const float2 kf = *reinterpret_cast<const float2*>(
                  ks + (8 * j + gid) * LDK + 8 * kk + 2 * tig);
              mma_3xtf32(sacc[j], ah, al, kf.x, kf.y);
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              const T* kr = ks + (8 * j + gid) * LDK + 16 * kk + 2 * tig;
              mma_bf16(sacc[j], qh[kk], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
            }
        }

        // mask, scale, online softmax on the fragments: elements 0, 1 are row
        // r0 (keys 8j + 2t, + 1), elements 2, 3 row r1
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * j + 2 * tig + (i & 1);
            const int row = i < 2 ? r0 : r1;
            const bool live = key < S && (!causal || key <= row + q_off);
            sacc[j][i] = live ? sacc[j][i] * scale2 : -INFINITY;
            mx[i >> 1] = fmaxf(mx[i >> 1], sacc[j][i]);
          }
        float mu[2], alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[r], mx[r]);
          mu[r] = mn == -INFINITY ? 0.f : mn;  // a row with no live key yet
          alpha[r] = exp2f(m[r] - mu[r]);
          m[r] = mn;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = exp2f(sacc[j][i] - mu[i >> 1]);
            lsum[i >> 1] += p;
            sacc[j][i] = p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], lsum[r]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          oacc[n][0] *= alpha[0];
          oacc[n][1] *= alpha[0];
          oacc[n][2] *= alpha[1];
          oacc[n][3] *= alpha[1];
        }

        // O += P V
        if constexpr (kF32) {
          // S tile j is one k step: A column t <-> key 8j + 2t (elements 0,
          // 2), t + 4 <-> key 8j + 2t + 1 (elements 1, 3)
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float pa[4] = {sacc[j][0], sacc[j][2], sacc[j][1],
                                 sacc[j][3]};
            uint32_t ah[4], al[4];
            split_a(pa, ah, al);
            const float* v0 = vs + (8 * j + 2 * tig) * LDV + gid;
#pragma unroll
            for (int n = 0; n < NO; ++n)
              mma_3xtf32(oacc[n], ah, al, v0[8 * n], v0[LDV + 8 * n]);
          }
        } else {
          const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
            const T* vrow = vs + (16 * kk + (mi & 1) * 8 + rr) * LDV;
            if constexpr (NO >= 2) {
#pragma unroll
              for (int n = 0; n < NO; n += 2) {
                uint32_t bv[4];
                ldsm_x4_trans(bv, vrow + 8 * n + (mi >> 1) * 8);
                mma_bf16(oacc[n], pa, bv[0], bv[1]);
                mma_bf16(oacc[n + 1], pa, bv[2], bv[3]);
              }
            } else {
              uint32_t bv[2];
              ldsm_x2_trans(bv, vrow);
              mma_bf16(oacc[0], pa, bv[0], bv[1]);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with stage it & 1
    }
    cp_async_wait<0>();

    if (warp_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      T* ob = o + b * sob + h * soh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? r1 : r0;
        if (row >= T_) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        T* orow = ob + row * sot + 2 * tig;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          orow[8 * n] = from_f32<T>(oacc[n][2 * r] * inv);
          orow[8 * n + 1] = from_f32<T>(oacc[n][2 * r + 1] * inv);
        }
      }
    }
  }
}

// Lets kernel take smem bytes of dynamic shared memory on the current
// device, once per kernel and device (set_on: bit d for device d).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       std::atomic<unsigned long long>& set_on) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (set_on.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) set_on.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int T_, int S, int causal,
                   int q_off, int warps, int heads, int balance, int vec,
                   const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, BK>(warps);
  auto kernel = q_off ? flash_attention_kernel<T, D, BK, true>
                      : flash_attention_kernel<T, D, BK, false>;
  static std::atomic<unsigned long long> smem_set[2]{};
  const cudaError_t err = allow_smem(kernel, smem_bytes<T, D, BK>(kMaxWarps),
                                     smem_set[q_off ? 1 : 0]);
  if (err != cudaSuccess) return err;
  const int rows = kWarpRows * warps / heads;
  const int nqb = (T_ + rows - 1) / rows;
  const dim3 grid(balance ? (nqb + 1) / 2 : nqb, B * (H / heads));
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, T_, S, causal,
      q_off, heads, balance, vec, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

template <typename T, int BK>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Hkv, int T_, int S, int D, int causal,
                     int q_off, int warps, int heads, int balance, int vec,
                     const long long* st, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8, BK>(q, k, v, o, B, H, Hkv, T_, S, causal,
                                    q_off, warps, heads, balance, vec, st,
                                    scale, s);
    case 16: return launch<T, 16, BK>(q, k, v, o, B, H, Hkv, T_, S, causal,
                                      q_off, warps, heads, balance, vec, st,
                                      scale, s);
    case 32: return launch<T, 32, BK>(q, k, v, o, B, H, Hkv, T_, S, causal,
                                      q_off, warps, heads, balance, vec, st,
                                      scale, s);
    case 64: return launch<T, 64, BK>(q, k, v, o, B, H, Hkv, T_, S, causal,
                                      q_off, warps, heads, balance, vec, st,
                                      scale, s);
    case 128: return launch<T, 128, BK>(q, k, v, o, B, H, Hkv, T_, S, causal,
                                        q_off, warps, heads, balance, vec, st,
                                        scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// K/V tiles of bk rows: 32 in f32, 64 in bf16 (the plan's KV_ROWS)
template <typename T>
constexpr int kBK = sizeof(T) == 4 ? 32 : 64;

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int Hkv, int T_, int S, int D, int causal, int q_off, int warps,
        int heads, int balance, int bk, int vec, const long long* strides,
        float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B < 0 || T_ < 0 || S < 0 || q_off < 0 ||
      static_cast<long long>(B) * H > 65535 ||
      !(warps == 1 || warps == 2 || warps == 4) || heads < 1 ||
      warps % heads != 0 || (H / Hkv) % heads != 0 || bk != kBK<T>) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || T_ == 0) return 0;
  return static_cast<int>(dispatch<T, kBK<T>>(
      q, k, v, o, B, H, Hkv, T_, S, D, causal, q_off, warps, heads, balance,
      vec, strides, scale, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, or cudaErrorInvalidValue for a plan the kernel does
// not take.  Pointers are device pointers; ``strides`` is a host array of
// twelve element strides: (b, h, t) of q, k, v and o in that order; stream
// is a cudaStream_t.  q_off (>= 0): query row t sees keys s <= t + q_off
// when causal.  The plan: warps (1, 2, 4) of a block, `heads` of them
// on one KV head's query heads, balance: each block takes two groups of
// query rows (the x-th latest and earliest), bk K/V rows a tile (32 f32, 64
// bf16); vec:
// k and v and their strides are 16-byte aligned.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int T, int S, int D, int causal,
                                   int q_off, int warps, int heads,
                                   int balance, int bk, int vec,
                                   const long long* strides, float scale,
                                   void* stream) {
  return run<float>(q, k, v, o, B, H, Hkv, T, S, D, causal, q_off, warps,
                    heads, balance, bk, vec, strides, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int T, int S, int D, int causal,
                                    int q_off, int warps, int heads,
                                    int balance, int bk, int vec,
                                    const long long* strides, float scale,
                                    void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, H, Hkv, T, S, D, causal, q_off,
                            warps, heads, balance, bk, vec, strides, scale,
                            stream);
}
