// Paged decode attention for Hopper (sm_90a).
//
// The paper's decode query (section 3.4): one new token per sequence joins
// the sequence's cached K/V rows, which live in fixed-size pages of a pool
// shared by all sequences and are found through a per-sequence page table
// (the address split token // page -> page id, token % page -> slot).
//
//   q [B, H, D], k/v pools [P, page, Hkv, D] (any strides, unit inner),
//   page_table [B, max_pages] int32 (-1 = unmapped), lengths [B] int32
//   -> out [B, H, D] (contiguous)
//
// Port of the TPU kernel src/repro/kernels/paged_attention.py (_kernel and
// paged_attention).  There the grid is (B, max_pages) with pages as the
// sequential inner axis, the page table is scalar-prefetched into the
// BlockSpec index map, and the running max / sum / accumulator live in VMEM
// scratch across grid steps.  Here one thread block owns one (sequence,
// KV head) pair and its g = H / Hkv query rows, and walks that sequence's
// live pages in a loop of its own: the online-softmax state stays in shared
// memory and registers, and no block waits on another.  The block reads
// its own page-table entries and length, so the host never sizes the loop
// (no device-to-host sync): pages with an id < 0 and pages at or past the
// length are skipped, slots at or past the length are masked, and the
// output is acc / max(l, 1e-30), so a sequence of length 0 gives zeros --
// the TPU kernel's semantics.
//
// Bound: each cached K/V element is read once for about 2 * g flops, far
// below the card's balance point, so the kernel is bound by the bytes of
// the live rows.  Each step stages kTile slots of one page's K and V head
// slice ([slots, D] at the pool's slot stride) into shared memory with
// coalesced D-contiguous loads, computes the g x kTile scores, updates the
// running max and sum with one warp per query row, and adds P V into a
// [g, D] float32 accumulator held in registers (thread = one column).
// Only B * Hkv blocks run (32 at B = 4 for Llama-3-8B), so at small batch
// most SMs idle: split-K flash-decoding is the later design.
//
// Arithmetic is full f32 on the CUDA cores.  bf16 inputs are widened to
// f32 when staged; as in the TPU kernel, p is rounded to the value dtype
// before the P V product while the running sum uses the unrounded p.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;       // cache slots per step: one per warp lane
constexpr int kMaxGroup = 16;   // query heads per KV head

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

// p as the P V product sees it: rounded to the value dtype
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_floats(int g) {
  return static_cast<size_t>(g) * D + kTile * (D + 1) + kTile * D +
         static_cast<size_t>(g) * (kTile + 1) + 3 * static_cast<size_t>(g);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int Hkv, int page, int max_pages,
                       long long sqb, long long sqh, long long skp,
                       long long sks, long long skh, long long svp,
                       long long svs, long long svh, float scale) {
  static_assert(kTile == 32, "softmax maps one slot to one warp lane");
  static_assert(D <= kThreads && kThreads % D == 0, "head dim");
  constexpr int kRowStep = kThreads / D;  // query rows updated at once
  constexpr int kRows = (kMaxGroup + kRowStep - 1) / kRowStep;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                    // [g][D]       query rows
  float* ks = qs + g * D;              // [kTile][D+1] staged K slots
  float* vs = ks + kTile * (D + 1);    // [kTile][D]   staged V slots
  float* ps = vs + kTile * D;          // [g][kTile+1] scores, then p
  float* ms = ps + g * (kTile + 1);    // [g] running max
  float* ls = ms + g;                  // [g] running sum
  float* as = ls + g;                  // [g] this step's rescale

  const T* qb = q + b * sqb + static_cast<long long>(hk) * g * sqh;
  for (int e = tid; e < g * D; e += kThreads) {
    qs[e] = to_f32(qb[(e / D) * sqh + e % D]);
  }
  for (int r = tid; r < g; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }

  // thread (r0, j): column j of query rows r0 + i * kRowStep
  const int j = tid % D;
  const int r0 = tid / D;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  const int length = lengths[b];
  const int* pt = page_table + static_cast<long long>(b) * max_pages;
  __syncthreads();
  for (int p = 0; p < max_pages && p * page < length; ++p) {
    const int pid = pt[p];
    if (pid < 0) continue;  // unmapped page: skipped
    const int n = min(page, length - p * page);  // live slots of the page
    const T* kp = k_pool + pid * skp + hk * skh;
    const T* vp = v_pool + pid * svp + hk * svh;
    for (int s0 = 0; s0 < n; s0 += kTile) {
      const int ns = min(kTile, n - s0);
      for (int e = tid; e < ns * D; e += kThreads) {
        const int s = e / D, c = e % D;
        ks[s * (D + 1) + c] = to_f32(kp[(s0 + s) * sks + c]);
        vs[s * D + c] = to_f32(vp[(s0 + s) * svs + c]);
      }
      __syncthreads();
      for (int e = tid; e < g * kTile; e += kThreads) {
        const int r = e / kTile, s = e % kTile;
        float sc = -INFINITY;  // masked slot
        if (s < ns) {
          const float* qr = qs + r * D;
          const float* kr = ks + s * (D + 1);
          float dot = 0.f;
#pragma unroll 8
          for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
          sc = dot * scale;
        }
        ps[r * (kTile + 1) + s] = sc;
      }
      __syncthreads();
      for (int r = warp; r < g; r += kThreads / 32) {
        float* pr = ps + r * (kTile + 1);
        const float s = pr[lane];
        // the step holds at least one live slot, so m_new is finite
        const float m_prev = ms[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float e = expf(s - m_new);
        const float sum = warp_sum(e);
        pr[lane] = round_to<T>(e);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          ms[r] = m_new;
          ls[r] = alpha * ls[r] + sum;
          as[r] = alpha;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kRowStep;
        if (r < g) {
          const float* pr = ps + r * (kTile + 1);
          float a = as[r] * acc[i];
          for (int s = 0; s < ns; ++s) a = fmaf(pr[s], vs[s * D + j], a);
          acc[i] = a;
        }
      }
      __syncthreads();
    }
  }

  T* ob = out + (static_cast<long long>(b) * H + hk * g) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i * kRowStep;
    if (r < g) ob[r * D + j] = from_f32<T>(acc[i] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths, void* out,
                   int B, int H, int Hkv, int page, int max_pages,
                   long long sqb, long long sqh, long long skp, long long sks,
                   long long skh, long long svp, long long svs, long long svh,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>(H / Hkv) * sizeof(float);
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, page,
      max_pages, sqb, sqh, skp, sks, skh, svp, svs, svh, scale);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k_pool, const void* v_pool,
        const void* page_table, const void* lengths, void* out, int B, int H,
        int Hkv, int D, int page, int max_pages, long long sqb, long long sqh,
        long long skp, long long sks, long long skh, long long svp,
        long long svs, long long svh, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || page <= 0 ||
      max_pages < 0 || B < 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ATTENTION_CASE(DIM)                                            \
  case DIM:                                                                  \
    return static_cast<int>(launch<T, DIM>(                                  \
        q, k_pool, v_pool, page_table, lengths, out, B, H, Hkv, page,        \
        max_pages, sqb, sqh, skp, sks, skh, svp, svs, svh, scale, s));
  switch (D) {
    PAGED_ATTENTION_CASE(8)
    PAGED_ATTENTION_CASE(16)
    PAGED_ATTENTION_CASE(32)
    PAGED_ATTENTION_CASE(64)
    PAGED_ATTENTION_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_ATTENTION_CASE
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  Pointers are device pointers, strides are in
// elements, stream is a cudaStream_t.
extern "C" int paged_attention_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int Hkv, int D, int page, int max_pages, long long sqb, long long sqh,
    long long skp, long long sks, long long skh, long long svp, long long svs,
    long long svh, float scale, void* stream) {
  return run<float>(q, k_pool, v_pool, page_table, lengths, out, B, H, Hkv, D,
                    page, max_pages, sqb, sqh, skp, sks, skh, svp, svs, svh,
                    scale, stream);
}

extern "C" int paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int Hkv, int D, int page, int max_pages, long long sqb, long long sqh,
    long long skp, long long sks, long long skh, long long svp, long long svs,
    long long svh, float scale, void* stream) {
  return run<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths, out, B, H,
                            Hkv, D, page, max_pages, sqb, sqh, skp, sks, skh,
                            svp, svs, svh, scale, stream);
}
