// Chunked relational GEMM for Hopper (sm_90a): C = X * W^T.
//
// The paper's MatMul (section 2.2): the chunk tables R_X(i, c, x_chunk) and
// R_W(j, c, w_chunk) are equi-joined on the chunk key c and aggregated with
// SUM(dot(x_chunk, w_chunk)) grouped by (i, j).  Rows are K-contiguous with
// a caller-given row stride (ldx, ldw, ldo), so row-major views of the
// executor's chunk tables pass without a copy.
//
// Port of the TPU kernel src/repro/kernels/chunked_matmul.py (_kernel and
// chunked_matmul).  There the chunk key is the sequential third grid axis
// and a VMEM scratch tile carries the gamma-SUM across grid steps; here each
// thread block owns one BM x BN output tile and walks the whole K range in
// a loop of its own, so the SUM lives in registers and no block waits on
// another.  Ragged M/N/K edges are masked in the kernel, so the caller
// pads nothing.
//
// Bound: at decode shapes (M = 1..4 rows) the work is about 2 flops per
// byte of W, far below the card's f32 balance point: every W element must
// cross from device memory exactly once and the kernel is bound by the
// bytes of W.  The small-M tiling (BM = 16, M <= 16) keeps every decode row
// in one block row, so W is read once; 128-deep K tiles give each block
// 16 KB of W loads per step, and the next tile's loads are issued into
// registers before the current tile's FMA loop so that their latency
// overlaps the arithmetic.  Warps whose rows are all past M skip the FMA
// loop.  Prefill shapes (M > 16) use 64 x 64 tiles with a 4 x 4 register
// tile per thread.
//
// Arithmetic is full f32 on the CUDA cores (no TF32).  bf16 inputs are
// widened to f32 when staged in shared memory, summed in f32 and rounded
// to bf16 once at the end, as the TPU kernel's preferred_element_type=f32.
// The K loop runs in the same order for every tiling, so the result does
// not depend on the relational chunk size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// One block: a BM x BN tile of C.  Thread (ty, tx) owns rows
// ty + i * THREADS_M (i < TM) and columns tx + j * THREADS_N (j < TN).
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
chunked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, int M, int N, int K,
                      long long ldx, long long ldw, long long ldo) {
  constexpr int THREADS_N = BN / TN;
  constexpr int THREADS_M = BM / TM;
  static_assert(THREADS_N * THREADS_M == kThreads, "tile/thread mismatch");
  constexpr int LX = BM * BK / kThreads;  // X elements a thread stages
  constexpr int LW = BN * BK / kThreads;  // W elements a thread stages
  static_assert(LX * kThreads == BM * BK && LW * kThreads == BN * BK,
                "tile not divisible among threads");

  // K-major tiles; the +1 pad keeps the transposing stores conflict-free
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_N;
  const int ty = tid / THREADS_N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // register stage of the next K tile (consecutive threads read
  // consecutive k of one row: coalesced)
  T xr[LX];
  T wr[LW];
  const T zero = from_f32<T>(0.f);

  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LX; ++l) {
      const int e = tid + l * kThreads;
      const int r = row0 + e / BK, k = k0 + e % BK;
      xr[l] = (r < M && k < K) ? x[r * ldx + k] : zero;
    }
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int e = tid + l * kThreads;
      const int r = col0 + e / BK, k = k0 + e % BK;
      wr[l] = (r < N && k < K) ? w[r * ldw + k] : zero;
    }
  };

  const bool active = row0 + ty < M;  // rows grow with i: all masked if not
  const int n_tiles = (K + BK - 1) / BK;
  load(0);
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int l = 0; l < LX; ++l) {
      const int e = tid + l * kThreads;
      xs[e % BK][e / BK] = to_f32(xr[l]);
    }
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int e = tid + l * kThreads;
      ws[e % BK][e / BK] = to_f32(wr[l]);
    }
    __syncthreads();
    if (t + 1 < n_tiles) load((t + 1) * BK);
    if (active) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * THREADS_M];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[k][tx + j * THREADS_N];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * THREADS_M;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * THREADS_N;
      if (r < M && c < N) out[r * ldo + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const T* x, const T* w, T* out, int M, int N, int K,
            long long ldx, long long ldw, long long ldo,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  chunked_matmul_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, kThreads, 0, stream>>>(x, w, out, M, N, K, ldx, ldw, ldo);
}

template <typename T>
int run(const void* x, const void* w, void* out, int M, int N, int K,
        long long ldx, long long ldw, long long ldo, void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    launch<T, 16, 32, 128, 2, 1>(xp, wp, op, M, N, K, ldx, ldw, ldo, s);
  } else {
    launch<T, 64, 64, 32, 4, 4>(xp, wp, op, M, N, K, ldx, ldw, ldo, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  Pointers are device pointers; stream is a
// cudaStream_t.
extern "C" int chunked_matmul_f32(const void* x, const void* w, void* out,
                                  int M, int N, int K, long long ldx,
                                  long long ldw, long long ldo,
                                  void* stream) {
  return run<float>(x, w, out, M, N, K, ldx, ldw, ldo, stream);
}

extern "C" int chunked_matmul_bf16(const void* x, const void* w, void* out,
                                   int M, int N, int K, long long ldx,
                                   long long ldw, long long ldo,
                                   void* stream) {
  return run<__nv_bfloat16>(x, w, out, M, N, K, ldx, ldw, ldo, stream);
}
