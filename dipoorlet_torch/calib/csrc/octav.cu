// OCTAV MSE-optimal clip per sample row, many tensors per launch, on NVIDIA
// Hopper (sm_90a).
//
// Replaces: the JAX package's calib/kernels.py:_octav_kernel (called through
// octav_pallas), which pins one sample's tensor in TPU VMEM (up to 2M
// elements), reads it from HBM once and runs the whole fixed point from there.
//
// What it computes, for each row r of each tensor x (batch rows of n elements):
//   min, max over the row;  s0 = sum|x| / max(#(|x| > 0), 1);
//   at most 20 times, while |s - prev| >= 1e-6:
//     s <- sum_{|x|>s} |x| / max(coef * #(|x| <= s) + #(|x| > s), 1e-30)
//   with coef = 1/4^8/3/u, u = 4 when dynamic_sym and |min| < 1e-6, else 1.
//   out[index * batch + r] = (s, min, max), f32.  The loop ends exactly as
//   the XLA fallback's lax.while_loop (calib/stats.py:57-69 there) ends.
//
// What bounds it on the H100: operations.  Each fixed-point iteration is a
// compare, a select-add and a count per element, one instruction each at
// 132 SMs x 128 lanes per clock, and up to 20 iterations follow the one read
// of x (B * n * sizeof(T) bytes at 3.35 TB/s).  A kernel that re-read the
// row from L2 or HBM every iteration would be bound by those reads instead.
//
// What this design does about it:
//   * One launch covers up to kMaxEntries tensors of one dtype: a table of
//     (pointer, n, chunk, index) entries passed by value as a
//     __grid_constant__ parameter, so a launch needs no copy and no
//     allocation.  Each (entry, sample row) is one problem.
//   * A problem belongs to a thread-block cluster of 1, 2, 4 or 8 blocks
//     (fixed per launch).  Block `rank` of the cluster takes elements
//     [rank * chunk, (rank + 1) * chunk) of the row.  Pass 1 reads its slice
//     from device memory once, keeps the first `held` elements in its own
//     shared memory (at the slice's alignment mod 16, so 16-byte loads work on
//     both copies) and reduces min, max, sum|x| and #(|x| > 0).  Every
//     iteration after that reads shared memory only.  The part of a slice
//     beyond `held` (a row larger than 8 blocks can hold) stays in device
//     memory and is re-read each iteration: one code path for every n.
//   * Every block reduces its partial to one value that all its threads hold
//     bit for bit, writes it to its own shared memory and, after one
//     cluster.sync(), every thread of every block folds the cluster's partials
//     through distributed shared memory in rank order.  So every thread of
//     the cluster derives the same s and leaves the loop at the same
//     iteration: a block that stopped early would hang the others at their
//     next barrier.  The partial slots are double-buffered, so one
//     cluster.sync() per reduction suffices.
//   * The launch's dynamic shared memory is sized to its class (the planner
//     in calib/kernels.py groups rows by dtype, cluster size and whether two
//     blocks fit on one SM), so small rows run two blocks per SM.
//   * The wrapper launches the classes on side streams of the caller's
//     stream, so that one class's last wave shares the card with the next
//     class instead of leaving SMs idle.
// Counts are 32-bit integers across threads (the wrapper keeps n below
// 2^31) and sums f32.
//
// NaN inputs give an unspecified result (calibration activations are
// finite); +-inf takes part in min/max and the sums as IEEE arithmetic says.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIter = 20;
constexpr int kMaxEntries = 64;   // OCTAV_MAX_ENTRIES in calib/kernels.py
constexpr int kMaxCluster = 8;
constexpr int kStaticSmem = 512;  // OCTAV_STATIC_SMEM: the static shared memory reserved
constexpr int kAlign = 16;        // OCTAV_ALIGN: slack that keeps the copy 16-byte aligned

struct Entry {      // OctavEntry in calib/build.py
  const void* x;    // batch rows of n elements, contiguous
  int n;
  int chunk;        // elements of a row that each block of a cluster takes (the last fewer)
  int index;        // the tensor's place in the caller's list
};

struct Table {
  Entry e[kMaxEntries];
};

// One block's contribution to a reduction: pass 1 uses all four fields
// (min, max, sum|x|, #(|x| > 0)), an iteration two (sum over |x| > s, count).
struct Partial {
  float a, b, c;
  int k;
};

struct FirstPass {
  __device__ static Partial combine(Partial x, Partial y) {
    return {fminf(x.a, y.a), fmaxf(x.b, y.b), x.c + y.c, x.k + y.k};
  }
  __device__ static Partial shfl(Partial v, int o) {
    return {__shfl_xor_sync(0xffffffffu, v.a, o), __shfl_xor_sync(0xffffffffu, v.b, o),
            __shfl_xor_sync(0xffffffffu, v.c, o), __shfl_xor_sync(0xffffffffu, v.k, o)};
  }
};

struct Iteration {
  __device__ static Partial combine(Partial x, Partial y) {
    return {x.a + y.a, 0.f, 0.f, x.k + y.k};
  }
  __device__ static Partial shfl(Partial v, int o) {
    return {__shfl_xor_sync(0xffffffffu, v.a, o), 0.f, 0.f, __shfl_xor_sync(0xffffffffu, v.k, o)};
  }
};

static_assert(sizeof(Partial) * (kWarps + 2) <= kStaticSmem, "static shared memory over budget");

// Reduces v over the cluster.  Every thread of every block returns the same
// value bit for bit: warps reduce by butterfly, every thread folds the warp
// partials in the same order, and every thread folds the blocks' partials in
// rank order.  `slot` alternates between two buffers from one call to the
// next; the cluster.sync() of call k+1 orders call k's remote reads before
// call k+2's write of the same buffer, and (being a block barrier too) this
// call's reads of warp_part before the next call's writes.
template <class Op>
__device__ __forceinline__ Partial cluster_reduce(Partial v, Partial* warp_part, Partial* slot,
                                                  const cg::cluster_group& cluster) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = Op::combine(v, Op::shfl(v, o));
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  Partial b = warp_part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) b = Op::combine(b, warp_part[w]);
  if (threadIdx.x == 0) *slot = b;
  cluster.sync();
  Partial r = *cluster.map_shared_rank(slot, 0);
  for (unsigned rank = 1; rank < cluster.num_blocks(); ++rank)
    r = Op::combine(r, *cluster.map_shared_rank(slot, rank));
  return r;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The values of one 16-byte word as f32 (bf16 is the upper half of an f32).
__device__ __forceinline__ void unpack(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(uint4 raw, float (&v)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Calls f(value as f32) once for each of the `count` elements at src, spread
// over the block's threads: scalar loads up to the first 16-byte boundary,
// 16-byte loads after it, scalar loads for the tail.  With kCopy it also
// stores every element to dst, which must have src's alignment mod 16.
template <bool kCopy, typename T, typename F>
__device__ __forceinline__ void sweep(const T* src, T* dst, int count, F f) {
  constexpr int kVec = kAlign / sizeof(T);
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(src) % kAlign / sizeof(T));
  const int head = min(count, (kVec - misalign) % kVec);
  const int body = (count - head) / kVec;
  for (int i = threadIdx.x; i < head; i += kThreads) {
    const T v = src[i];
    if constexpr (kCopy) dst[i] = v;
    f(to_f32(v));
  }
  const uint4* src_v = reinterpret_cast<const uint4*>(src + head);
#pragma unroll 4
  for (int j = threadIdx.x; j < body; j += kThreads) {
    const uint4 raw = src_v[j];
    if constexpr (kCopy) reinterpret_cast<uint4*>(dst + head)[j] = raw;
    float v[kVec];
    unpack(raw, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) f(v[k]);
  }
  for (int i = head + body * kVec + threadIdx.x; i < count; i += kThreads) {
    const T v = src[i];
    if constexpr (kCopy) dst[i] = v;
    f(to_f32(v));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
octav_kernel(const __grid_constant__ Table table, int batch, int held, int dynamic_sym,
             float* __restrict__ out) {
  __shared__ Partial warp_part[kWarps];
  __shared__ Partial slot[2];
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int problem = blockIdx.x / cluster.num_blocks();
  const Entry& e = table.e[problem / batch];
  const int r = problem % batch;

  // this block's slice of the row: `on` elements kept here, `rest` re-read
  const int64_t lo = min(static_cast<int64_t>(cluster.block_rank()) * e.chunk,
                         static_cast<int64_t>(e.n));
  const int len = static_cast<int>(min(static_cast<int64_t>(e.chunk), e.n - lo));
  const int on = min(len, held);
  const T* src = static_cast<const T*>(e.x) + static_cast<int64_t>(r) * e.n + lo;
  T* buf = reinterpret_cast<T*>(smem) + reinterpret_cast<uintptr_t>(src) % kAlign / sizeof(T);
  const T* rest = src + on;
  const int rest_n = len - on;

  // A thread counts in f32, exact below 2^24 (it sees at most n / kThreads
  // elements): a predicated add is one instruction where an integer count
  // compiles to an add and a select.
  float mn = INFINITY, mx = -INFINITY, sum = 0.f, nnz = 0.f;
  auto first = [&](float v) {
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
    const float a = fabsf(v);
    sum += a;
    if (a > 0.f) nnz += 1.f;
  };
  sweep<true>(src, buf, on, first);
  sweep<false>(rest, static_cast<T*>(nullptr), rest_n, first);
  const Partial p = cluster_reduce<FirstPass>({mn, mx, sum, static_cast<int>(nnz)}, warp_part,
                                              &slot[0], cluster);

  const float u = (dynamic_sym && fabsf(p.a) < 1e-6f) ? 4.f : 1.f;
  const float coef = static_cast<float>(1.0 / 65536.0 / 3.0) / u;
  float s = p.c / static_cast<float>(p.k > 1 ? p.k : 1);
  float prev = s + 1.f;
  for (int it = 0; it < kMaxIter && fabsf(s - prev) >= 1e-6f; ++it) {
    float num = 0.f, gt = 0.f;
    auto step = [&](float v) {
      const float a = fabsf(v);
      if (a > s) {
        num += a;
        gt += 1.f;
      }
    };
    sweep<false>(static_cast<const T*>(buf), static_cast<T*>(nullptr), on, step);
    sweep<false>(rest, static_cast<T*>(nullptr), rest_n, step);
    const Partial q = cluster_reduce<Iteration>({num, 0.f, 0.f, static_cast<int>(gt)},
                                                warp_part, &slot[(it + 1) & 1], cluster);
    const float den = coef * static_cast<float>(e.n - q.k) + static_cast<float>(q.k);
    prev = s;
    s = q.a / fmaxf(den, 1e-30f);
  }
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    float* o = out + 3 * (static_cast<int64_t>(e.index) * batch + r);
    o[0] = s;
    o[1] = p.a;
    o[2] = p.b;
  }
  cluster.sync();  // no block leaves while another may still read its slots
}

template <typename T>
int launch(const Entry* entries, int count, int cluster, int batch, int held, int smem_bytes,
           int dynamic_sym, float* out, cudaStream_t stream) {
  Table table = {};
  for (int i = 0; i < count; ++i) table.e[i] = entries[i];
  cudaError_t err = cudaFuncSetAttribute(octav_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(octav_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(count) * batch * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, octav_kernel<T>, table, batch, held, dynamic_sym, out);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// entries: `count` (1..kMaxEntries) tensors of one dtype (0 = f32, 1 = bf16),
// each (batch, n) contiguous; `cluster` blocks (1, 2, 4 or 8) share a row and
// each keeps `held` elements of it in `smem_bytes` of dynamic shared memory
// (held * sizeof(T) + kAlign at least).  out: (tensors, batch, 3) f32.
// Launches on `stream` of `device`, allocates nothing, returns the error of
// cudaFuncSetAttribute or cudaLaunchKernelEx, else cudaGetLastError().
extern "C" int octav_launch(const void* entries, int count, int dtype, int cluster, int batch,
                            int held, int smem_bytes, int dynamic_sym, void* out, void* stream,
                            int device) {
  if (count < 1 || count > kMaxEntries || batch < 1 || held < 1 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      static_cast<long long>(count) * batch * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Entry* e = static_cast<const Entry*>(entries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(e, count, cluster, batch, held, smem_bytes, dynamic_sym, o, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(e, count, cluster, batch, held, smem_bytes, dynamic_sym, o, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
