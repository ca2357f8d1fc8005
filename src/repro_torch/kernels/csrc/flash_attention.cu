// Causal flash attention (prefill) for Hopper (sm_90a).
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
// kernel's signature.  The causal mask is top-left aligned (query t sees
// keys s <= t), so T < S is legal: the prefill over a cache_len-deep cache.
//
// Port of the TPU kernel src/repro/kernels/flash_attention.py (_kernel and
// flash_attention).  There the grid is (B*H, T/bq, S/bk) with the KV tiles
// as the sequential inner axis and the running max / sum / accumulator in
// VMEM scratch; it asserts T % bq == 0 and S % bk == 0.  Here one thread
// block owns one (b, h) and kBQ query rows and loops over the KV tiles
// itself, with the state in registers.  Ragged T and S are masked in the
// kernel, since prompts have any length.  KV tiles that start past the
// block's last query row (causal) or past S are never loaded.
//
// Layout of a block: 128 threads, four per query row.  Thread (r, u) owns
// score columns u + 4 i of its row and output dims u + 4 i; the row's
// max and sum are reduced over the four with warp shuffles.  Q, the staged
// K and V tiles and the tile's p live in shared memory (padded rows keep
// the column reads conflict-free); at D = 128 that is 53.6 KB, above the
// 48 KB default, so the launch raises the block's dynamic shared memory
// limit.
//
// Bound: the causal products take 4 * D flops per (query, live key) pair;
// at prefill lengths that is above the f32 balance point, so the bound is
// the f32 rate of the CUDA cores (67 TFLOP/s on an H100 SXM).  This simple
// kernel reads both operands of every FMA from shared memory and does not
// approach it; wgmma tiles, TMA loads and warp specialisation are the later
// design.
//
// Arithmetic is full f32 (no TF32).  bf16 inputs are widened when staged;
// p is rounded to the value dtype before the P V product and the running
// sum uses the unrounded p, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per block (four threads each)
constexpr int kBK = 32;  // key rows per step

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

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// reduce over the four threads of one query row (lanes 4r' .. 4r' + 3)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Hkv, int T_, int S, int causal, long long sqb,
                       long long sqh, long long sqt, long long skb,
                       long long skh, long long sks, long long svb,
                       long long svh, long long svs, long long sob,
                       long long soh, long long sot, float scale) {
  static_assert(kThreads == 4 * kBQ && kBK % 4 == 0 && D % 4 == 0, "layout");
  constexpr int kCols = kBK / 4;  // score columns per thread
  constexpr int kDims = D / 4;    // output dims per thread

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / 4, u = tid % 4;
  const int t = q0 + r;  // this thread's query row

  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][D+1]
  float* ks = qs + kBQ * (D + 1);    // [kBK][D+1]
  float* vs = ks + kBK * (D + 1);    // [kBK][D]
  float* ps = vs + kBK * D;          // [kBQ][kBK+1]

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int rr = e / D, c = e % D;
    qs[rr * (D + 1) + c] = q0 + rr < T_ ? to_f32(qb[(q0 + rr) * sqt + c]) : 0.f;
  }

  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int q_last = min(q0 + kBQ, T_) - 1;
  const int kv_end = causal ? min(S, q_last + 1) : S;
  const float* qr = qs + r * (D + 1);
  float* pr = ps + r * (kBK + 1);
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q staged; the last step's reads of K, V are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int s = e / D, c = e % D;
      const bool live = k0 + s < S;
      ks[s * (D + 1) + c] = live ? to_f32(kb[(k0 + s) * sks + c]) : 0.f;
      vs[s * D + c] = live ? to_f32(vb[(k0 + s) * svs + c]) : 0.f;
    }
    __syncthreads();

    float sc[kCols];
    float m_cur = -INFINITY;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int s = u + 4 * i, sk = k0 + s;
      const float* kr = ks + s * (D + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
      const bool live = sk < S && t < T_ && (!causal || sk <= t);
      sc[i] = live ? dot * scale : -INFINITY;
      m_cur = fmaxf(m_cur, sc[i]);
    }
    const float m_new = fmaxf(m, quad_max(m_cur));
    float alpha = 1.f, sum = 0.f;
    if (m_new == -INFINITY) {
      // no live key for this row yet (a padded row past T)
#pragma unroll
      for (int i = 0; i < kCols; ++i) pr[u + 4 * i] = 0.f;
    } else {
      alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const float e = expf(sc[i] - m_new);
        sum += e;
        pr[u + 4 * i] = round_to<T>(e);
      }
    }
    l = alpha * l + quad_sum(sum);
    m = m_new;
    __syncwarp();  // the row's p was written by the four threads of its quad

#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int c = u + 4 * i;
      float a = alpha * acc[i];
#pragma unroll 8
      for (int s = 0; s < kBK; ++s) a = fmaf(pr[s], vs[s * D + c], a);
      acc[i] = a;
    }
  }

  if (t < T_) {
    T* orow = o + b * sob + h * soh + t * sot;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDims; ++i) orow[u + 4 * i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int T_, int S, int causal,
                   const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T_ + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, T_, S, causal,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int Hkv, int T_, int S, int D, int causal, const long long* strides,
        float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B < 0 || T_ < 0 || S < 0 ||
      static_cast<long long>(B) * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || T_ == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ATTENTION_CASE(DIM)                                           \
  case DIM:                                                                 \
    return static_cast<int>(launch<T, DIM>(q, k, v, o, B, H, Hkv, T_, S,    \
                                           causal, strides, scale, s));
  switch (D) {
    FLASH_ATTENTION_CASE(8)
    FLASH_ATTENTION_CASE(16)
    FLASH_ATTENTION_CASE(32)
    FLASH_ATTENTION_CASE(64)
    FLASH_ATTENTION_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_ATTENTION_CASE
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  Pointers are device pointers; ``strides`` is a
// host array of twelve element strides: (b, h, t) of q, k, v and o in that
// order; stream is a cudaStream_t.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int T, int S, int D, int causal,
                                   const long long* strides, float scale,
                                   void* stream) {
  return run<float>(q, k, v, o, B, H, Hkv, T, S, D, causal, strides, scale,
                    stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int T, int S, int D, int causal,
                                    const long long* strides, float scale,
                                    void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, H, Hkv, T, S, D, causal, strides,
                            scale, stream);
}
