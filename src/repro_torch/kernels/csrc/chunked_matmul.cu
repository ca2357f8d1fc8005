// Chunked relational GEMM for Hopper (sm_90a): C = X * W^T.
//
// The paper's MatMul (section 2.2): the chunk tables R_X(i, c, x_chunk) and
// R_W(j, c, w_chunk) are equi-joined on the chunk key c and aggregated with
// SUM(dot(x_chunk, w_chunk)) grouped by (i, j).  Rows are K-contiguous with
// a caller-given row stride (ldx, ldw, ldo), so row-major views of the
// executor's chunk tables pass without a copy.
//
// Replaces the TPU kernel src/repro/kernels/chunked_matmul.py (_kernel and
// chunked_matmul).  There the chunk key is the sequential third grid axis
// and a VMEM scratch tile carries the gamma-SUM across grid steps.  Here a
// block sums its own K slab in registers, and where one slab per output
// tile would leave the card's 132 SMs short of work, K is split over a grid
// axis.  The slabs' partial sums are added in slab order, never with float
// atomics, so two launches on the same inputs give the same bits.  Ragged
// M/N/K edges are masked in the kernel, so the caller pads nothing.  The
// caller (kernels/chunked_matmul.py, _plan) picks the regime, the tile, the
// slab and the split; this file carries them out.
//
// Decode regime (M <= 16 rows), gemv_kernel.  About 2 * M flops per 4-byte
// W element, far below the card's f32 balance point (67 TFLOP/s against
// 3.35 TB/s is 20 flops a byte): bound by the bytes of W, each of which
// must cross from device memory once.  Each warp streams 2 W rows (for one
// X row) or 4 with 16-byte read-only loads, 4 vectors of each row in
// flight per lane (the first batch is issued before X is staged); X's rows
// for the block's K slab are staged once in shared memory as f32 and read
// as 16-byte loads; every W element meets all M rows while it is in
// registers; the loop has no __syncthreads, and a warp-shuffle butterfly
// sums the lanes.
// K is split into at most 8 slabs that run as one thread-block cluster:
// each block leaves its partial sums in shared memory and the block of
// slab 0 adds them through distributed shared memory, so the split needs
// no workspace and no second launch.
//
// Prefill regime (M > 16), gemm_kernel.  At M = 64 the main-path shapes do
// 32 flops per W byte, above the balance point: bound by the f32 FMA rate
// of the CUDA cores (the bytes bound is 0.6x the flops bound).  A 4-stage
// ring of BM x BK and 128 x BK tiles in shared memory is filled by
// cp.async straight from the K-contiguous rows (no register staging, no
// transposing stores); each thread keeps an 8 x 8 register tile (4 x 8 at
// BM = 32) and reads its fragments as 16-byte shared loads along K, from
// rows padded so that a warp's loads hit distinct banks; one __syncthreads
// per K tile.  K is split only to fill one wave of resident blocks: the
// slabs write float32 partials to a caller-given workspace, and a second
// kernel adds them.
//
// The 16-byte vector paths need 16-byte aligned pointers and row strides,
// and K a multiple of the vector; otherwise the caller asks for the scalar
// path, which loads one element at a time.
//
// Column layouts (the planner's ROW2COL tables), C = X * W.  A COL_CHUNK
// table W__col(d, c, chunk[cs']) is W transposed, [K, N] with N contiguous;
// a COL_CHUNK_HEADS table is H such [K, Nh] blocks, one a head, at a head
// stride, and C[:, h Nh + j] = sum_k X[:, k] W[h][k][j].  Tiles never cross
// a head: the grid's column axis has H * ceil(Nh / tile) entries.  The
// blocks are read in place (a transpose on the fly would move the bytes
// the layout saves):
// - decode, gemv_col_kernel: a block owns 32 lanes x 4 contiguous columns
//   of one head (one column a lane on the scalar path); its 8 warps take
//   interleaved rows k of its K slab, so a warp reads 512 contiguous bytes
//   of W per row (16-byte loads, the next U rows in flight per lane while
//   the current U are summed), and each lane keeps the 4 columns' sums for
//   every X row.  The warps' sums are added
//   in shared memory in warp order, then the K slabs of the cluster
//   through distributed shared memory, as in gemv_kernel.  Bound by the
//   bytes of W, as the row layout's GEMV.
// - prefill, gemm_kernel<COL = true>: the B tile is loaded N-major by
//   cp.async ([BK][128] rows of contiguous columns, padded) and a thread
//   owns two runs of 4 columns, read as shared loads along N; the
//   A side, the pipeline, the split and the reduction are the row layout's.
//
// Arithmetic is full f32 on the CUDA cores (no TF32, no tensor cores).
// bf16 inputs are widened to f32 on load, summed in f32 and rounded to
// bf16 once at the end, as the TPU kernel's preferred_element_type=f32.
// Each output's sum runs in one fixed order that depends on (M, N, K), the
// plan and the alignment only, so it does not depend on the relational
// chunk size.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// bf16 -> f32 is a 16-bit shift: the low element of a 32-bit word is the
// first in memory
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// VEC elements of T read as one load (16 bytes, or one element) and
// widened to f32
template <typename T, int VEC>
struct Pack;
template <>
struct Pack<float, 4> {
  using Raw = float4;
  __device__ static void unpack(const float4& r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};
template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static void unpack(const uint4& r, float (&f)[8]) {
    f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z); f[5] = bf16_hi(r.z);
    f[6] = bf16_lo(r.w); f[7] = bf16_hi(r.w);
  }
};
template <>
struct Pack<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ static void unpack(const uint2& r, float (&f)[4]) {
    f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
  }
};
template <>
struct Pack<float, 1> {
  using Raw = float;
  __device__ static void unpack(const float& r, float (&f)[1]) { f[0] = r; }
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static void unpack(const __nv_bfloat16& r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
  }
};

// VEC consecutive f32 of shared memory (16-byte loads where VEC allows)
template <int VEC>
__device__ __forceinline__ void lds_f32(const float* p, float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void sts_f32(float* p, const float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = f[i];
  }
}

// ---------------------------------------------------------------------------
// Decode regime: weight-streaming GEMV, M <= MB <= 16
// ---------------------------------------------------------------------------

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;

// Grid (ceil(N / 8R), splits), launched as clusters of (1, splits, 1)
// blocks.  Block (bx, z) owns the 8R W rows from 8R bx over K slab
// [z kslab, min(K, (z + 1) kslab)).  Lane l of a warp sums vectors l,
// l + 32, ... of the slab; U vectors of each of the warp's R rows are
// loaded before any is used, the first U while X is being staged.  With
// splits > 1 each block leaves its 8R x M partial sums in shared memory
// and the cluster's block of slab 0 adds them, in slab order, through
// distributed shared memory: no workspace and no second launch.
template <typename T, int MB, int VEC, int U, int R>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, int M, int N, int K, long long ldx,
            long long ldw, long long ldo, int kslab) {
  using P = Pack<T, VEC>;
  using Raw = typename P::Raw;
  constexpr int ROWS = kGemvWarps * R;  // W rows of the block
  extern __shared__ __align__(16) float xs[];  // [MB][kslab] X, f32
  float* const part = xs + MB * kslab;          // [MB][ROWS] partial sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.y * kslab;
  const int nv = min(kslab, K - k0) / VEC;  // vectors in this slab
  const int n0 = blockIdx.x * ROWS + warp * R;
  const Raw* wr[R];
#pragma unroll
  for (int r = 0; r < R; ++r)  // rows past N re-read row N - 1
    wr[r] = reinterpret_cast<const Raw*>(
        w + static_cast<long long>(min(n0 + r, N - 1)) * ldw + k0);

  Raw wv[U][R];
  auto load_group = [&](int v) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) wv[u][r] = __ldg(wr[r] + v + 32 * u);
  };
  const int full_end = nv - 32 * (U - 1);  // a whole group starts below it
  if (lane < full_end) load_group(lane);

  // stage X[:, slab] once; rows M..MB-1 are zeros
  for (int e = tid; e < MB * nv; e += kGemvThreads) {
    const int m = e / nv, v = e - m * nv;
    float f[VEC];
    if (m < M) {
      P::unpack(__ldg(reinterpret_cast<const Raw*>(x + m * ldx + k0) + v), f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
    sts_f32<VEC>(xs + m * kslab + v * VEC, f);
  }
  __syncthreads();

  float acc[MB][R];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[m][r] = 0.f;

  auto fma_vec = [&](const Raw (&wvec)[R], int v) {
    float wf[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) P::unpack(wvec[r], wf[r]);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      float xf[VEC];
      lds_f32<VEC>(xs + m * kslab + v * VEC, xf);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[m][r] = fmaf(xf[i], wf[r][i], acc[m][r]);
    }
  };

  int v = lane;
  for (; v < full_end; v += 32 * U) {
    if (v != lane) load_group(v);
#pragma unroll
    for (int u = 0; u < U; ++u) fma_vec(wv[u], v + 32 * u);
  }
  for (; v < nv; v += 32) {
    Raw tail[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tail[r] = __ldg(wr[r] + v);
    fma_vec(tail, v);
  }

  // butterfly: every lane ends with the same sum (a + b == b + a)
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m][r] += __shfl_xor_sync(0xffffffffu, acc[m][r], off);

  const int splits = gridDim.y;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (((m * R + r) & 31) != lane || m >= M) continue;
      if (splits == 1) {
        if (n0 + r < N) out[m * ldo + n0 + r] = from_f32<T>(acc[m][r]);
      } else {
        part[m * ROWS + warp * R + r] = acc[m][r];
      }
    }
  if (splits == 1) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every slab's partials are in its block's shared memory
  if (blockIdx.y == 0) {
    for (int i = tid; i < M * ROWS; i += kGemvThreads) {
      const int n = blockIdx.x * ROWS + i % ROWS;
      float sum = part[i];
      for (int q = 1; q < splits; ++q)
        sum += cluster.map_shared_rank(part, q)[i];
      if (n < N) out[(i / ROWS) * ldo + n] = from_f32<T>(sum);
    }
  }
  cluster.sync();  // keep each block's partials until slab 0 has read them
}

// ---------------------------------------------------------------------------
// Decode regime, column layouts: GEMV over [K, Nh] blocks, M <= MB <= 16
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Grid (H * tph, splits), tph = ceil(Nh / (32 VEC)) column tiles a head,
// launched as clusters of (1, splits, 1).  Block (bx, z) owns columns
// [t 32 VEC, (t + 1) 32 VEC) of head h = bx / tph (t = bx % tph) over K
// slab [z kslab, min(K, (z + 1) kslab)).  Warp w takes the slab's rows
// w, w + 8, ...; lane l the columns t 32 VEC + l VEC + [0, VEC).
template <typename T, int MB, int VEC, int U>
__global__ void __launch_bounds__(kGemvThreads)
gemv_col_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int M, int Nh, int K, long long ldx,
                long long ldw, long long ldh, long long ldo, int kslab,
                int tph) {
  using P = Pack<T, VEC>;
  using Raw = typename P::Raw;
  constexpr int BN = 32 * VEC;
  extern __shared__ __align__(16) float xs[];  // [MB][kslab] X, f32
  float* const red = xs + MB * kslab;           // [8][MB][BN] warp sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x / tph;
  const int t0 = (blockIdx.x - h * tph) * BN;
  const int c = t0 + lane * VEC;  // the lane's first column in the head
  const bool col_ok = c < Nh;     // the vector path has Nh % VEC == 0
  const int k0 = blockIdx.y * kslab;
  const int kn = min(kslab, K - k0);
  const T* wp = w + h * ldh + static_cast<long long>(k0) * ldw +
                (col_ok ? c : 0);

  // two groups of U rows in registers: one is summed while the next one's
  // loads are in flight
  Raw wa[U], wb[U];
  auto load_rows = [&](Raw (&wv)[U], int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + 8 * u;
      if (col_ok && kk < kn)
        wv[u] = __ldg(reinterpret_cast<const Raw*>(wp + kk * ldw));
    }
  };
  load_rows(wa, warp);  // the first rows fly while X is staged

  // stage X[:, slab] once; rows M..MB-1 are zeros
  for (int e = tid; e < MB * kn; e += kGemvThreads) {
    const int m = e / kn, k = e - m * kn;
    xs[m * kslab + k] = m < M ? to_f32(x[m * ldx + k0 + k]) : 0.f;
  }
  __syncthreads();

  float acc[MB][VEC];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[m][i] = 0.f;

  auto sum_rows = [&](const Raw (&wv)[U], int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + 8 * u;
      if (!col_ok || kk >= kn) continue;
      float wf[VEC];
      P::unpack(wv[u], wf);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xv = xs[m * kslab + kk];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[m][i] = fmaf(xv, wf[i], acc[m][i]);
      }
    }
  };
  // rows ascend in one fixed order: groups k, k + 8U, k + 16U, ...
  for (int k = warp; k < kn; k += 16 * U) {
    load_rows(wb, k + 8 * U);
    sum_rows(wa, k);
    load_rows(wa, k + 16 * U);
    sum_rows(wb, k + 8 * U);
  }

  // the 8 warps' sums, added in warp order into warp 0's rows
  float* mine = red + warp * MB * BN + lane * VEC;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < VEC; ++i) mine[m * BN + i] = acc[m][i];
  __syncthreads();
  for (int e = tid; e < MB * BN; e += kGemvThreads) {
    float sum = red[e];
#pragma unroll
    for (int q = 1; q < kGemvWarps; ++q) sum += red[q * MB * BN + e];
    red[e] = sum;  // each thread rewrites only the entries it read
  }

  const int splits = gridDim.y;
  auto store = [&](int e, float v) {
    const int m = e / BN, col = t0 + e % BN;
    if (m < M && col < Nh) out[m * ldo + h * Nh + col] = from_f32<T>(v);
  };
  if (splits == 1) {
    for (int e = tid; e < MB * BN; e += kGemvThreads) store(e, red[e]);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every slab's sums are in its block's shared memory
  if (blockIdx.y == 0) {
    for (int e = tid; e < MB * BN; e += kGemvThreads) {
      float sum = red[e];
      for (int q = 1; q < splits; ++q)
        sum += cluster.map_shared_rank(red, q)[e];
      store(e, sum);
    }
  }
  cluster.sync();  // keep each block's sums until slab 0 has read them
}

// ---------------------------------------------------------------------------
// Prefill regime: cp.async-pipelined register-tiled GEMM, M > 16
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 128;  // 2 x 2 warps, each 4 x 8 lanes
constexpr int kStages = 4;
constexpr int kTN = 8;             // columns a thread owns
constexpr int kBN = 2 * 8 * kTN;   // 128

// row stride of a tile in shared memory: one 16-byte pad per row
template <typename T, int BK>
constexpr int kGemmLds = BK + 16 / static_cast<int>(sizeof(T));
// the column layouts' B tile: BK rows of 128 columns, padded alike
template <typename T>
constexpr int kGemmLdsCol = kBN + 16 / static_cast<int>(sizeof(T));

template <typename T, int TM, int BK, bool COL>
constexpr size_t gemm_smem() {
  return static_cast<size_t>(kStages) *
         (8 * TM * kGemmLds<T, BK> +
          (COL ? BK * kGemmLdsCol<T> : kBN * kGemmLds<T, BK>)) *
         sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 consecutive K elements of a tile row, widened to f32
__device__ __forceinline__ void lds4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x);
  f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
}

// A thread's 8 columns of a column-layout B tile row, widened to f32:
// elements [0, 4) and [32, 36) from p, so that the 8 lanes reading one row
// cover 32 consecutive elements a load (no bank conflict)
__device__ __forceinline__ void lds_col(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 32);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void lds_col(const __nv_bfloat16* p,
                                        float (&f)[8]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const uint2 b = *reinterpret_cast<const uint2*>(p + 32);
  f[0] = bf16_lo(a.x); f[1] = bf16_hi(a.x);
  f[2] = bf16_lo(a.y); f[3] = bf16_hi(a.y);
  f[4] = bf16_lo(b.x); f[5] = bf16_hi(b.x);
  f[6] = bf16_lo(b.y); f[7] = bf16_hi(b.y);
}

// Grid (H * ceil(N / 128), ceil(M / BM), splits), BM = 8 TM, BK-deep K
// tiles; N is a head's width (H = 1 in the row layout).  Lane (ty, tx) of
// warp (wy, wx) owns rows wy 4TM + ty + 4i (i < TM) and columns
// wx 64 + tx + 8j (j < 8) of the block's tile, or
// wx 64 + 32 (j / 4) + 4 tx + j % 4 in the column layouts: the rows (or,
// in the column layouts, the column runs) a warp reads at one step are
// consecutive, so its fragment loads fall in distinct banks.
template <typename T, int TM, int BK, bool VECTOR, bool COL>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, float* __restrict__ ws, int M, int N, int K,
            long long ldx, long long ldw, long long ldh, long long ldo,
            int kslab, int tph, int n_total) {
  constexpr int BM = 8 * TM;
  constexpr int LDS = kGemmLds<T, BK>;
  constexpr int LDB = COL ? kGemmLdsCol<T> : LDS;  // B tile row stride
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int CPR = BK / EPC;                         // chunks per row
  constexpr int CPRB = kBN / EPC;       // chunks per column-layout B row
  constexpr int CHUNKS_A = BM * CPR;
  constexpr int CHUNKS = CHUNKS_A + (COL ? BK * CPRB : kBN * CPR);
  constexpr int B_TILE = COL ? BK * LDB : kBN * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const As = reinterpret_cast<T*>(smem_raw);  // [kStages][BM][LDS]
  T* const Bs = As + kStages * BM * LDS;         // [kStages][B_TILE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7;
  const int wm = (warp >> 1) * 4 * TM, wn = (warp & 1) * 8 * kTN;
  const int h = COL ? blockIdx.x / tph : 0;
  const int row0 = blockIdx.y * BM, col0 = (blockIdx.x - h * tph) * kBN;
  const T* const wh = w + h * ldh;
  const int kb = blockIdx.z * kslab, ke = min(K, kb + kslab);
  const int ntiles = (ke - kb + BK - 1) / BK;
  const T zero = from_f32<T>(0.f);

  auto load_tile = [&](int stage, int t) {
    const int k0 = kb + t * BK;
#pragma unroll
    for (int c0 = 0; c0 < CHUNKS; c0 += kGemmThreads) {
      const int c = c0 + tid;
      if (CHUNKS % kGemmThreads != 0 && c >= CHUNKS) break;
      if (COL && c >= CHUNKS_A) {
        // a 16-byte run of N of row k0 + r of the [K, N] block
        const int cc = c - CHUNKS_A;
        const int r = cc / CPRB, nc = (cc % CPRB) * EPC;
        const int gk = k0 + r, gc = col0 + nc;
        T* dst = Bs + stage * B_TILE + r * LDB + nc;
        const T* src = wh + static_cast<long long>(gk) * ldw + gc;
        if constexpr (VECTOR) {
          // N is a multiple of EPC: a chunk is all in or all out
          const bool ok = gk < ke && gc < N;
          cp_async16(dst, ok ? src : w, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            dst[e] = (gk < ke && gc + e < N) ? src[e] : zero;
        }
        continue;
      }
      const bool is_a = c < BM * CPR;
      const int cc = is_a ? c : c - BM * CPR;
      const int r = cc / CPR, kc = (cc % CPR) * EPC;
      const int grow = (is_a ? row0 : col0) + r;
      const bool row_ok = grow < (is_a ? M : N);
      const T* base = is_a ? x : w;
      const long long ld = is_a ? ldx : ldw;
      T* dst = (is_a ? As + stage * BM * LDS : Bs + stage * B_TILE) +
               r * LDS + kc;
      const int gk = k0 + kc;
      if constexpr (VECTOR) {
        // K and the slab are multiples of EPC: a chunk is all in or all out
        const bool ok = row_ok && gk < ke;
        cp_async16(dst, ok ? base + grow * ld + gk : base, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          dst[e] = (row_ok && gk + e < ke) ? base[grow * ld + gk + e] : zero;
      }
    }
  };

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // ... for every thread; stage t-1 is free
    if (t + kStages - 1 < ntiles)
      load_tile((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();

    const int stage = t % kStages;
    const T* as = As + stage * BM * LDS + (wm + ty) * LDS;
    const T* bs = Bs + stage * B_TILE +
                  (COL ? wn + 4 * tx : (wn + tx) * LDS);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float a[TM][4], b[kTN][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) lds4(as + 4 * i * LDS + kk, a[i]);
      if constexpr (COL) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[kTN];
          lds_col(bs + (kk + q) * LDB, f);
#pragma unroll
          for (int j = 0; j < kTN; ++j) b[j][q] = f[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kTN; ++j) lds4(bs + 8 * j * LDS + kk, b[j]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + wm + ty + 4 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + wn +
                    (COL ? 32 * (j >> 2) + 4 * tx + (j & 3) : tx + 8 * j);
      if (r < M && c < N) {
        const int oc = h * N + c;  // column of the [M, H N] output
        if (gridDim.z == 1)
          out[r * ldo + oc] = from_f32<T>(acc[i][j]);
        else
          ws[(static_cast<long long>(blockIdx.z) * M + r) * n_total + oc] =
              acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Split-K: out = sum over z of ws[z], added in z order
// ---------------------------------------------------------------------------

constexpr int kReduceThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                     int M, int N, long long ldo, int splits) {
  const long long mn = static_cast<long long>(M) * N;
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= mn) return;
  float s = ws[i];
  for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
  out[(i / N) * ldo + i % N] = from_f32<T>(s);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// the X slab a decode block stages, and its partial sums
constexpr int kGemvMaxSlabBytes = 112 * 1024;
constexpr int kGemvMaxSplits = 8;  // a portable cluster

// Lets kernel take smem bytes of dynamic shared memory on the current
// device.  The attribute is set once per kernel and device: set_on is the
// caller's per-kernel static, bit d standing for device d.
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

template <typename T, int MB, int VEC, int U, int R>
cudaError_t launch_gemv(const T* x, const T* w, T* out, int M, int N, int K,
                        long long ldx, long long ldw, long long ldo,
                        int splits, int kslab, cudaStream_t stream) {
  constexpr int rows = kGemvWarps * R;
  constexpr size_t part_bytes = MB * rows * sizeof(float);
  const size_t slab_bytes = static_cast<size_t>(MB) * kslab * sizeof(float);
  if (slab_bytes > static_cast<size_t>(kGemvMaxSlabBytes) ||
      splits > kGemvMaxSplits)
    return cudaErrorInvalidValue;
  auto kernel = gemv_kernel<T, MB, VEC, U, R>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err =
      allow_smem(kernel, kGemvMaxSlabBytes + part_bytes, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + rows - 1) / rows, splits);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = slab_bytes + part_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;  // the K slabs of one row block
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, out, M, N, K, ldx, ldw, ldo,
                            kslab);
}

// Decode tiles the caller may ask for, (MB, W rows of a block): one X row
// takes 2 W rows a warp, more X rows 4.  Each lane keeps 4 vectors of each
// of its W rows in flight, 1 where 8 or 16 X rows' accumulators take the
// registers.
template <typename T, int VEC>
cudaError_t dispatch_gemv(const T* x, const T* w, T* out, int M, int N,
                          int K, long long ldx, long long ldw, long long ldo,
                          int mb, int rows, int splits, int kslab,
                          cudaStream_t s) {
  const int key = mb * 1000 + rows;
  switch (key) {
    case 1016:
      return launch_gemv<T, 1, VEC, 4, 2>(x, w, out, M, N, K, ldx, ldw,
                                           ldo, splits, kslab, s);
    case 2032:
      return launch_gemv<T, 2, VEC, 4, 4>(x, w, out, M, N, K, ldx, ldw,
                                           ldo, splits, kslab, s);
    case 4032:
      return launch_gemv<T, 4, VEC, 4, 4>(x, w, out, M, N, K, ldx, ldw,
                                           ldo, splits, kslab, s);
    case 8032:
      return launch_gemv<T, 8, VEC, 1, 4>(x, w, out, M, N, K, ldx, ldw,
                                           ldo, splits, kslab, s);
    case 16032:
      return launch_gemv<T, 16, VEC, 1, 4>(x, w, out, M, N, K, ldx, ldw,
                                            ldo, splits, kslab, s);
    default: return cudaErrorInvalidValue;
  }
}

// H blocks of N columns (H = 1 and ldh unused in the row layout)
template <typename T, int TM, int BK, bool VECTOR, bool COL>
cudaError_t launch_gemm(const T* x, const T* w, T* out, float* ws, int M,
                        int H, int N, int K, long long ldx, long long ldw,
                        long long ldh, long long ldo, int splits, int kslab,
                        cudaStream_t stream) {
  constexpr size_t smem = gemm_smem<T, TM, BK, COL>();
  auto kernel = gemm_kernel<T, TM, BK, VECTOR, COL>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int tph = (N + kBN - 1) / kBN;
  const dim3 grid(H * tph, (M + 8 * TM - 1) / (8 * TM), splits);
  kernel<<<grid, kGemmThreads, smem, stream>>>(x, w, out, ws, M, N, K, ldx,
                                               ldw, ldh, ldo, kslab, tph,
                                               H * N);
  return cudaGetLastError();
}

// Prefill tiles the caller may ask for, (BM, 128, BK): an 8 x 8 register
// tile over 16-deep K tiles, or a 4 x 8 one over 32-deep tiles for M <= 32
template <typename T, bool COL>
cudaError_t dispatch_gemm(const T* x, const T* w, T* out, float* ws, int M,
                          int H, int N, int K, long long ldx, long long ldw,
                          long long ldh, long long ldo, int bm, int bk,
                          int splits, int kslab, bool vector,
                          cudaStream_t s) {
  auto launch = [&](auto kernel_launch) {
    return kernel_launch(x, w, out, ws, M, H, N, K, ldx, ldw, ldh, ldo,
                         splits, kslab, s);
  };
  if (bm == 64 && bk == 16)
    return vector ? launch(launch_gemm<T, 8, 16, true, COL>)
                  : launch(launch_gemm<T, 8, 16, false, COL>);
  if (bm == 32 && bk == 32)
    return vector ? launch(launch_gemm<T, 4, 32, true, COL>)
                  : launch(launch_gemm<T, 4, 32, false, COL>);
  return cudaErrorInvalidValue;
}

// The prefill's split-K reduction, after the GEMM on the same stream
template <typename T>
cudaError_t launch_reduce(const float* ws, T* out, int M, int N,
                          long long ldo, int splits, cudaStream_t stream) {
  const long long mn = static_cast<long long>(M) * N;
  const unsigned blocks =
      static_cast<unsigned>((mn + kReduceThreads - 1) / kReduceThreads);
  splitk_reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(
      ws, out, M, N, ldo, splits);
  return cudaGetLastError();
}

// regime 0 = decode (tile_m = MB, the padded row count: 1, 2, 4, 8 or 16;
// tile_n = W rows of a block; tile_k unused; at most 8 splits, added in a
// cluster), regime 1 = prefill (tile = (BM, 128, BK); with splits > 1, ws
// holds splits * M * N floats).  splits K slabs of kslab elements cover K.
template <typename T>
int run(const void* x, const void* w, void* out, void* ws, int M, int N,
        int K, long long ldx, long long ldw, long long ldo, int regime,
        int tile_m, int tile_n, int tile_k, int splits, int kslab,
        int vector, void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  float* wsp = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int gran = vector ? kVec : 1;
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || kslab < 1 ||
      kslab % gran != 0 ||
      static_cast<long long>(splits - 1) * kslab >= (K > 0 ? K : 1) ||
      static_cast<long long>(splits) * kslab < K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (regime == 0) {
    if (M > tile_m) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        vector ? dispatch_gemv<T, kVec>(xp, wp, op, M, N, K, ldx, ldw, ldo,
                                        tile_m, tile_n, splits, kslab, s)
               : dispatch_gemv<T, 1>(xp, wp, op, M, N, K, ldx, ldw, ldo,
                                     tile_m, tile_n, splits, kslab, s));
  }
  if (regime != 1 || tile_n != kBN || tile_k < 1 || kslab % tile_k != 0 ||
      (splits > 1 && wsp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dispatch_gemm<T, false>(xp, wp, op, wsp, M, 1, N, K, ldx,
                                            ldw, 0, ldo, tile_m, tile_k,
                                            splits, kslab, vector != 0, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_reduce<T>(wsp, op, M, N, ldo, splits, s));
}

// ---------------------------------------------------------------------------
// Column layouts: launchers
// ---------------------------------------------------------------------------

template <typename T, int MB, int VEC, int U>
cudaError_t launch_gemv_col(const T* x, const T* w, T* out, int M, int H,
                            int Nh, int K, long long ldx, long long ldw,
                            long long ldh, long long ldo, int splits,
                            int kslab, cudaStream_t stream) {
  constexpr int BN = 32 * VEC;
  constexpr size_t red_bytes = kGemvWarps * MB * BN * sizeof(float);
  const size_t slab_bytes = static_cast<size_t>(MB) * kslab * sizeof(float);
  if (slab_bytes > static_cast<size_t>(kGemvMaxSlabBytes) ||
      splits > kGemvMaxSplits)
    return cudaErrorInvalidValue;
  auto kernel = gemv_col_kernel<T, MB, VEC, U>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err =
      allow_smem(kernel, kGemvMaxSlabBytes + red_bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int tph = (Nh + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * tph, splits);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = slab_bytes + red_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;  // the K slabs of one column tile
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, out, M, Nh, K, ldx, ldw, ldh,
                            ldo, kslab, tph);
}

// Decode tiles of the column layouts, (MB, columns): 32 lanes x 4 columns
// (vector) or x 1 (scalar); 4 W rows a lane in flight, 2 where 8 or 16 X
// rows' sums take the registers
template <typename T, int VEC>
cudaError_t dispatch_gemv_col(const T* x, const T* w, T* out, int M, int H,
                              int Nh, int K, long long ldx, long long ldw,
                              long long ldh, long long ldo, int mb,
                              int splits, int kslab, cudaStream_t s) {
  switch (mb) {
    case 1:
      return launch_gemv_col<T, 1, VEC, 4>(x, w, out, M, H, Nh, K, ldx, ldw,
                                           ldh, ldo, splits, kslab, s);
    case 2:
      return launch_gemv_col<T, 2, VEC, 4>(x, w, out, M, H, Nh, K, ldx, ldw,
                                           ldh, ldo, splits, kslab, s);
    case 4:
      return launch_gemv_col<T, 4, VEC, 4>(x, w, out, M, H, Nh, K, ldx, ldw,
                                           ldh, ldo, splits, kslab, s);
    case 8:
      return launch_gemv_col<T, 8, VEC, 2>(x, w, out, M, H, Nh, K, ldx, ldw,
                                           ldh, ldo, splits, kslab, s);
    case 16:
      return launch_gemv_col<T, 16, VEC, 2>(x, w, out, M, H, Nh, K, ldx, ldw,
                                            ldh, ldo, splits, kslab, s);
    default: return cudaErrorInvalidValue;
  }
}

// x [M, K] (row stride ldx) times H blocks [K, Nh] of w (row stride ldw,
// head stride ldh) into out [M, H Nh] (row stride ldo).  regime 0 = decode
// (tile_m = MB, tile_n = 32 lanes x 4 or x 1 columns, tile_k unused; at
// most 8 splits, added in a cluster), regime 1 = prefill (as run()).
template <typename T>
int run_col(const void* x, const void* w, void* out, void* ws, int M, int H,
            int Nh, int K, long long ldx, long long ldw, long long ldh,
            long long ldo, int regime, int tile_m, int tile_n, int tile_k,
            int splits, int kslab, int vector, void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  float* wsp = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || H <= 0 || Nh <= 0 || K < 0 || splits < 1 || kslab < 1 ||
      static_cast<long long>(splits - 1) * kslab >= (K > 0 ? K : 1) ||
      static_cast<long long>(splits) * kslab < K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (regime == 0) {
    if (M > tile_m || tile_n != (vector ? 128 : 32))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        vector ? dispatch_gemv_col<T, 4>(xp, wp, op, M, H, Nh, K, ldx, ldw,
                                         ldh, ldo, tile_m, splits, kslab, s)
               : dispatch_gemv_col<T, 1>(xp, wp, op, M, H, Nh, K, ldx, ldw,
                                         ldh, ldo, tile_m, splits, kslab, s));
  }
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (regime != 1 || tile_n != kBN || tile_k < 1 || kslab % tile_k != 0 ||
      (vector && (kslab % kVec != 0 || Nh % kVec != 0)) ||
      (splits > 1 && wsp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dispatch_gemm<T, true>(xp, wp, op, wsp, M, H, Nh, K, ldx,
                                           ldw, ldh, ldo, tile_m, tile_k,
                                           splits, kslab, vector != 0, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      launch_reduce<T>(wsp, op, M, H * Nh, ldo, splits, s));
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launches, 0 on success, or cudaErrorInvalidValue for a plan the kernels do
// not take.  Pointers are device pointers; stream is a cudaStream_t.
extern "C" int chunked_matmul_f32(const void* x, const void* w, void* out,
                                  void* ws, int M, int N, int K,
                                  long long ldx, long long ldw, long long ldo,
                                  int regime, int tile_m, int tile_n,
                                  int tile_k, int splits, int kslab,
                                  int vector, void* stream) {
  return run<float>(x, w, out, ws, M, N, K, ldx, ldw, ldo, regime, tile_m,
                    tile_n, tile_k, splits, kslab, vector, stream);
}

extern "C" int chunked_matmul_bf16(const void* x, const void* w, void* out,
                                   void* ws, int M, int N, int K,
                                   long long ldx, long long ldw,
                                   long long ldo, int regime, int tile_m,
                                   int tile_n, int tile_k, int splits,
                                   int kslab, int vector, void* stream) {
  return run<__nv_bfloat16>(x, w, out, ws, M, N, K, ldx, ldw, ldo, regime,
                            tile_m, tile_n, tile_k, splits, kslab, vector,
                            stream);
}

extern "C" int chunked_matmul_col_f32(const void* x, const void* w, void* out,
                                      void* ws, int M, int H, int Nh, int K,
                                      long long ldx, long long ldw,
                                      long long ldh, long long ldo,
                                      int regime, int tile_m, int tile_n,
                                      int tile_k, int splits, int kslab,
                                      int vector, void* stream) {
  return run_col<float>(x, w, out, ws, M, H, Nh, K, ldx, ldw, ldh, ldo,
                        regime, tile_m, tile_n, tile_k, splits, kslab, vector,
                        stream);
}

extern "C" int chunked_matmul_col_bf16(const void* x, const void* w,
                                       void* out, void* ws, int M, int H,
                                       int Nh, int K, long long ldx,
                                       long long ldw, long long ldh,
                                       long long ldo, int regime, int tile_m,
                                       int tile_n, int tile_k, int splits,
                                       int kslab, int vector, void* stream) {
  return run_col<__nv_bfloat16>(x, w, out, ws, M, H, Nh, K, ldx, ldw, ldh,
                                ldo, regime, tile_m, tile_n, tile_k, splits,
                                kslab, vector, stream);
}
