// Paged decode attention for Hopper (sm_90a): split-K flash-decoding.
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
// Replaces the TPU kernel src/repro/kernels/paged_attention.py (_kernel and
// paged_attention).  There the grid is (B, max_pages) with pages as the
// sequential inner axis, the page table is scalar-prefetched into the
// BlockSpec index map, and the running max / sum / accumulator live in VMEM
// scratch across grid steps.  On this card a sequential walk over one
// sequence's pages by one block leaves most SMs idle at small batch (B * Hkv
// = 32 blocks at B = 4 with Llama-3-8B widths, on 132 SMs) and sets the
// launch's time by one block's latency.
//
// Bound: each cached K/V element is read once for about 2 * g flops, far
// below the card's balance point, so the kernel is bound by the bytes of
// the live rows (about 1.3 us for one 512-row sequence at Llama-3-8B widths
// in f32).  What keeps a launch from it is latency, so the design spreads
// the rows over many blocks and keeps many loads in flight:
//
// - Grid (Hkv, B, n_split).  Block (hk, b, s) reads lengths[b] and the page
//   table on the device (the host never sizes the loop) and takes the slots
//   [s c, min((s + 1) c, len)) with c = ceil(len / n_split) rounded up to
//   a multiple of c_min; the caller's plan (kernels/paged_attention.py,
//   _plan) picks n_split for about two waves of blocks, at most 16: the
//   splits of a (sequence, KV head) form one thread-block cluster.
//   Unmapped pages inside the range are skipped.
// - Inside a block each warp is split into NS lane groups of L lanes; a
//   group owns U cache slots a round and each of its lanes E = D / L
//   consecutive elements of those slots' K and V rows, read as 16-byte (or
//   8-byte) loads straight into registers, all U slots requested before
//   the first is used (one memory latency a round).  The page table's row
//   is read beside the length (a lane an entry, up to 32 pages) and handed
//   out by shuffles, so a slot waits on its K/V bytes only.  q's g rows of
//   the lane's E elements stay in registers, the dot products are summed
//   over the group's lanes with shuffles, and each group keeps its own
//   online-softmax state (max, sum, [g, E] accumulator) in registers,
//   updated once a round in log2 units (exp2): no shared memory and no
//   __syncthreads in the loop.  E is chosen so that q and the accumulator
//   take at most 64 registers for the g query heads sharing each K/V row,
//   U so that the rows in flight take at most 64 more.
// - At the end the groups of a warp are merged with shuffles, the four
//   warps through shared memory, and the splits in split order inside the
//   cluster through distributed shared memory, every rank merging its share
//   of the outputs (a second launch over a float32 workspace was slower on
//   the card, PERF.md).  Each merge takes one weight per (state, head),
//   then a weighted sum per element.  An empty split's state is (max -inf,
//   sum 0) and weighs nothing, so a sequence of length 0 gives zeros, the
//   TPU kernel's semantics.
//
// Pools whose base or strides are not 16-byte aligned take a scalar load
// path in the same kernel (vec = 0).  Arithmetic is full f32 on the CUDA
// cores.  bf16 inputs are widened to f32 on load; as in the TPU kernel, p is
// rounded to the value dtype before the P V product while the running sum
// uses the unrounded p.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 16;   // query heads per KV head
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;

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

__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// The weight of a state with max m (log2 domain) in a merge whose max is
// mm: 2^(m - mm), 0 for an empty state (m = -inf), never NaN.
__device__ __forceinline__ float weight(float m, float mm) {
  return m == -INFINITY ? 0.f : exp2f(m - mm);
}

// Lane geometry of a block for head dim D and G (g rounded up to a power of
// two) query heads per KV head: E elements of a row per lane, L lanes per
// slot, NS slots per warp step.  q and the accumulator take 2 G E <= 64
// registers where D allows (E >= D / 32, so that L <= 32).
template <int D, int G>
struct Geo {
  static constexpr int kWant = 32 / G;
  static constexpr int kLo = D / 32 > 4 ? D / 32 : 4;
  static constexpr int kHi = D < 16 ? D : 16;
  static constexpr int E = kWant < kLo ? kLo : (kWant > kHi ? kHi : kWant);
  static constexpr int L = D / E;
  static constexpr int NS = 32 / L;
  static_assert(D % E == 0 && L >= 1 && L <= 32 && 32 % L == 0, "geometry");
};

// E consecutive elements of a row, widened to f32: 16-byte loads (8-byte
// for 4 bf16) where vec, else one element at a time
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ p, bool vec,
                                         float (&f)[E]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
        f[4 * i] = v.x; f[4 * i + 1] = v.y;
        f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
      }
    } else if constexpr (E % 8 == 0) {
#pragma unroll
      for (int i = 0; i < E / 8; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        f[8 * i] = bf16_lo(v.x); f[8 * i + 1] = bf16_hi(v.x);
        f[8 * i + 2] = bf16_lo(v.y); f[8 * i + 3] = bf16_hi(v.y);
        f[8 * i + 4] = bf16_lo(v.z); f[8 * i + 5] = bf16_hi(v.z);
        f[8 * i + 6] = bf16_lo(v.w); f[8 * i + 7] = bf16_hi(v.w);
      }
    } else {
      static_assert(E == 4, "bf16 rows are read 4 or 8k elements a lane");
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x);
      f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = to_f32(p[e]);
  }
}

// Slots a lane group has in flight: its K and V rows take 2 U E registers,
// with q and the accumulator at most 128 in all (U = 4 at g = 4, D = 128).
template <int D, int G>
constexpr int kRoom = 64 / Geo<D, G>::E - G;
template <int D, int G>
constexpr int kInFlight = kRoom<D, G> >= 8   ? 8
                          : kRoom<D, G> >= 4 ? 4
                          : kRoom<D, G> >= 2 ? 2
                                             : 1;

// Shared memory of a block: the four warps' states, then the block's state
// (read by the cluster's ranks), then merge weights.  A
// state is m[G], l[G], acc[G][D], with m in the log2 domain.
template <int D, int G>
constexpr int kStateFloats = G * (D + 2);
constexpr int kWeightRows = kMaxCluster > kWarps ? kMaxCluster : kWarps;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int Hkv, int page, int max_pages, int c_min,
                       int vec, long long sqb, long long sqh, long long skp,
                       long long sks, long long skh, long long svp,
                       long long svs, long long svh, float scale) {
  using Gm = Geo<D, G>;
  constexpr int E = Gm::E, L = Gm::L, NS = Gm::NS;
  constexpr int U = kInFlight<D, G>;
  constexpr int SF = kStateFloats<D, G>;
  __shared__ float smem[(kWarps + 1) * SF + (kWeightRows + 2) * G];
  float* const bs = smem + kWarps * SF;        // the block's state
  float* const wt = bs + SF;                   // [rows][G] merge weights
  float* const wl = wt + kWeightRows * G;      // [G] merged sums
  float* const wm = wl + G;                    // [G] merged maxima

  const int hk = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int g = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / L, r = lane % L;
  const float scale2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

  // the page table's row (up to 32 pages: one a lane) is read beside the
  // length, not after it
  const int* pt = page_table + static_cast<long long>(b) * max_pages;
  const bool pt_in_lanes = max_pages <= 32;
  const int pt_lane = pt_in_lanes && lane < max_pages ? pt[lane] : -1;

  float qr[G][E];
  const T* qb = q + b * sqb + static_cast<long long>(hk) * g * sqh + r * E;
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[h][e] = h < g ? to_f32(qb[h * sqh + e]) : 0.f;

  // this split's slots
  const int len = max(0, min(lengths[b], max_pages * page));
  const int c =
      max(1, ((len + n_split - 1) / n_split + c_min - 1) / c_min) * c_min;
  const int s0 = static_cast<int>(
      min(static_cast<long long>(split) * c, static_cast<long long>(len)));
  const int s1 = min(s0 + c, len);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  const T* kb = k_pool + hk * skh + r * E;
  const T* vb = v_pool + hk * svh + r * E;
  // Warp-uniform loop (the shuffles need every lane): a round of the warp
  // covers NS U slots, lane group grp taking base + grp + NS u (u < U); all
  // U slots' K and V rows are requested before the first is used, and the
  // online softmax is updated once a round.
  constexpr int kWarpSlots = NS * U, kStep = kWarps * kWarpSlots;
  for (int base = s0 + warp * kWarpSlots; base < s1; base += kStep) {
    float kf[U][E], vf[U][E];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sl = base + grp + NS * u;
      const int pi = sl / page;
      int pid = pt_in_lanes ? __shfl_sync(0xffffffffu, pt_lane, pi & 31) : -1;
      if (!pt_in_lanes && sl < s1) pid = pt[pi];
      live[u] = sl < s1 && pid >= 0;  // unmapped pages are skipped
      if (live[u]) {
        const int so = sl - pi * page;
        load_row<T, E>(kb + pid * skp + so * sks, vec != 0, kf[u]);
        load_row<T, E>(vb + pid * svp + so * svs, vec != 0, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[h][e], kf[u][e], part);
        sc[u][h] = part;
      }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < G; ++h)
          sc[u][h] += __shfl_xor_sync(0xffffffffu, sc[u][h], off);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) break;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][h] = live[u] ? sc[u][h] * scale2 : -INFINITY;
        mx = fmaxf(mx, sc[u][h]);
      }
      const float mn = fmaxf(m[h], mx);
      const float alpha = weight(m[h], mn);
      float psum = 0.f, pr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = live[u] ? exp2f(sc[u][h] - mn) : 0.f;
        psum += p;
        pr[u] = round_to<T>(p);
      }
      l[h] = fmaf(l[h], alpha, psum);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[h][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(pr[u], vf[u][e], a);
        acc[h][e] = a;
      }
      m[h] = mn;
    }
  }

  // merge the warp's lane groups (lanes r, r + L, ... hold the same dims)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mm = fmaxf(m[h], m2);
      const float w1 = weight(m[h], mm), w2 = weight(m2, mm);
      l[h] = l[h] * w1 + l2 * w2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[h][e], off);
        acc[h][e] = acc[h][e] * w1 + a2 * w2;
      }
      m[h] = mm;
    }
  }
  float* st = smem + warp * SF;
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (r == 0) {
        st[h] = m[h];
        st[G + h] = l[h];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) st[2 * G + h * D + r * E + e] = acc[h][e];
    }
  }
  __syncthreads();

  // the block's state from its four warps, in warp order: one weight per
  // (warp, head), then each element a weighted sum
  if (tid < g) {
    const int h = tid;
    float mm = -INFINITY, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, smem[w * SF + h]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = weight(smem[w * SF + h], mm);
      wt[w * G + h] = x;
      ls = fmaf(x, smem[w * SF + G + h], ls);
    }
    wm[h] = mm;
    wl[h] = ls;
  }
  __syncthreads();
  T* ob = out + (static_cast<long long>(b) * H + hk * g) * D;
  for (int i = tid; i < g * D; i += kThreads) {
    const int h = i / D, col = i - h * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a = fmaf(wt[w * G + h], smem[w * SF + 2 * G + h * D + col], a);
    if (col == 0) {
      bs[h] = wm[h];
      bs[G + h] = wl[h];
    }
    bs[2 * G + h * D + col] = a;
  }

  // The cluster's splits, merged in split order.  Every rank computes the
  // (rank, head) weights, then writes its share of the g D outputs.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  __syncthreads();  // wt is rewritten below
  if (tid < g) {
    const int h = tid;
    float mz[kMaxCluster], lz[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      const float* rs = cluster.map_shared_rank(bs, z < n_split ? z : 0);
      mz[z] = z < n_split ? rs[h] : -INFINITY;
      lz[z] = z < n_split ? rs[G + h] : 0.f;
    }
    float mm = -INFINITY, ls = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) mm = fmaxf(mm, mz[z]);
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      const float x = weight(mz[z], mm);
      wt[z * G + h] = x;
      ls = fmaf(x, lz[z], ls);
    }
    wl[h] = ls;
  }
  __syncthreads();
  const int share = (g * D + n_split - 1) / n_split;
  const int i1 = min(g * D, (split + 1) * share);
  for (int i = split * share + tid; i < i1; i += kThreads) {
    const int h = i / D, col = i - h * D;
    float az[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z)
      az[z] = z < n_split
                  ? cluster.map_shared_rank(bs, z)[2 * G + h * D + col]
                  : 0.f;
    float a = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) a = fmaf(wt[z * G + h], az[z], a);
    ob[h * D + col] = from_f32<T>(a / fmaxf(wl[h], 1e-30f));
  }
  cluster.sync();  // keep each block's state until every rank has read it
}

struct Args {
  const void *q, *k_pool, *v_pool, *page_table, *lengths;
  void* out;
  int B, H, Hkv, page, max_pages, n_split, c_min, vec;
  long long sqb, sqh, skp, sks, skh, svp, svs, svh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int G>
cudaError_t launch(const Args& a) {
  auto kernel = paged_attention_kernel<T, D, G>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv, a.B, a.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.n_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.n_split > kPortableCluster) {
    // set once per kernel and device (bit d for device d)
    static std::atomic<unsigned long long> set_on{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(set_on.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      set_on.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), a.H,
      a.Hkv, a.page, a.max_pages, a.c_min, a.vec, a.sqb, a.sqh, a.skp, a.sks,
      a.skh, a.svp, a.svs, a.svh, a.scale);
}

template <typename T, int D>
cudaError_t dispatch_group(const Args& a) {
  const int g = a.H / a.Hkv;
  if (g <= 1) return launch<T, D, 1>(a);
  if (g <= 2) return launch<T, D, 2>(a);
  if (g <= 4) return launch<T, D, 4>(a);
  if (g <= 8) return launch<T, D, 8>(a);
  return launch<T, D, 16>(a);
}

template <typename T>
int run(const Args& a, int D) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || a.H / a.Hkv > kMaxGroup ||
      a.page <= 0 || a.max_pages < 0 || a.B < 0 || a.B > 65535 ||
      a.n_split < 1 || a.n_split > kMaxCluster || a.c_min < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.B == 0) return 0;
  switch (D) {
    case 8: return static_cast<int>(dispatch_group<T, 8>(a));
    case 16: return static_cast<int>(dispatch_group<T, 16>(a));
    case 32: return static_cast<int>(dispatch_group<T, 32>(a));
    case 64: return static_cast<int>(dispatch_group<T, 64>(a));
    case 128: return static_cast<int>(dispatch_group<T, 128>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface (loaded with ctypes): returns the launch's CUDA error, 0 on
// success, or cudaErrorInvalidValue for arguments the kernel
// does not take.  Pointers are device pointers, strides are in elements,
// stream is a cudaStream_t.  The n_split <= 16 splits of a (sequence, KV
// head) form one cluster.  vec: the pools' base pointers and strides are
// 16-byte aligned.
#define PAGED_ATTENTION_API(NAME, T)                                         \
  extern "C" int NAME(                                                       \
      const void* q, const void* k_pool, const void* v_pool,                 \
      const void* page_table, const void* lengths, void* out, int B, int H,  \
      int Hkv, int D, int page, int max_pages, int n_split, int c_min,       \
      int vec, long long sqb,                                                \
      long long sqh, long long skp, long long sks, long long skh,            \
      long long svp, long long svs, long long svh, float scale,              \
      void* stream) {                                                        \
    const Args a{q, k_pool, v_pool, page_table, lengths, out,                \
                 B, H, Hkv, page, max_pages, n_split, c_min,                 \
                 vec, sqb, sqh, skp, sks, skh, svp, svs, svh,                \
                 scale, static_cast<cudaStream_t>(stream)};                  \
    return run<T>(a, D);                                                     \
  }

PAGED_ATTENTION_API(paged_attention_f32, float)
PAGED_ATTENTION_API(paged_attention_bf16, __nv_bfloat16)
