// Fused |x| binning and exact histogram count, many tensors per launch, on
// NVIDIA Hopper (sm_90a).
//
// Replaces: the JAX package's calib/kernels.py:_hist_kernel (called through
// histogram_pallas / _histogram_pallas_jit), which counts int32 bucket
// indices as a digit-split one-hot matmul on the TPU's matrix unit, after
// the caller has binned |x| and written the indices out
// (calib/stats.py:435-462 there), and carries the count in VMEM across its
// sequential grid.
//
// What it computes: for every entry e of the launch's table (a tensor x of
// `batch` rows of e.n elements), every row r with valid[r] > 0, and every
// element v of the row,
//   bucket = min(max(int_rz(|v| * scales[e.t]), 0), bins - 1)
// and adds 1 to e.out[bucket] (int64, accumulated across calls).  The
// multiply is one f32 multiply rounded to nearest (__fmul_rn: no FMA
// contraction, no fast math), and int_rz truncates toward zero, so for every
// finite v the bucket equals the JAX package's clip(int32(|x|_f32 *
// scale_f32), 0, bins-1).  Non-finite values follow the same saturating
// conversion as XLA's: NaN goes to bucket 0, +inf to bucket bins-1.  The
// scales are read from the device, so the calibration pass needs no host
// sync between its minmax and histogram phases.
//
// What bounds it on the H100: bytes.  The least time is one read of the
// valid rows of x at 3.35 TB/s; the index tensor the TPU path writes and
// re-reads is gone.  What stands in the way is fixed cost: zeroing and
// flushing a shared histogram, global atomics, one launch per tensor.
//
// What this design does about it:
//   * One launch covers up to kMaxEntries tensors of one dtype: a table of
//     (pointer, out row, n, first element, scale index) entries passed by
//     value as a __grid_constant__ parameter, so a launch needs no copy and
//     no allocation.
//   * The entries' elements form one flat range, entry by entry and row by
//     row (`first` is where an entry starts in it).  Block b counts elements
//     [b * per_block, (b + 1) * per_block) of that range: its tiles, a tile
//     being the part of a run of consecutive valid rows of one entry that
//     falls in the block's range.  The planner in calib/kernels.py sizes the
//     grid to the card (SMs x resident blocks), so a block counts hundreds
//     of thousands of elements at the main path's sizes.
//   * A block keeps a `bins`-sized int32 histogram in shared memory.  It
//     zeroes it once, and flushes it into the entry's out row (one 64-bit
//     global atomic per non-zero bucket, leaving the bucket zero) only when
//     its range passes to the next entry and at its end: at most
//     (grid + entries - 1) flushes per launch, never one per few thousand
//     elements.
//   * A row with valid <= 0 is skipped before anything of it is read.
//   * Bucket 0 (about half of a ReLU output) is counted in a register by
//     each thread and added to the shared histogram once per flush, so the
//     zeros do not meet at one shared counter.  The other buckets take one
//     shared atomic per element (chip_smoke.py measured merging a warp's
//     equal buckets with __match_any_sync, and one histogram copy per warp:
//     both slower, PERF.md).
//   * The loads are kept in flight, not issued and waited for in turn: a
//     block reads each run of consecutive valid rows as the 16-byte words
//     (8 bf16 or 4 f32 values) that cover it, and each thread copies its
//     words into its own slots of a shared-memory ring with cp.async,
//     kRingDepth = 8 words ahead of the word it counts, so up to 2 x 7 x
//     8 KB per SM are on their way and no barrier is needed.  The elements
//     of a run's first and last word that lie outside it (rows of any
//     length start at any alignment) are masked; a 16-byte word never
//     leaves the memory page of the run's own bytes.  A histogram too large
//     to leave room for the ring's 64 KB (more than 41,728 bins, up to the
//     58,112 a block holds) takes a depth of 0: the same words loaded
//     straight into registers, one at a time.
// Offsets are 64-bit.  Shared counts are 32-bit: the planner keeps
// per_block below 2^31.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;      // BIN_COUNT_BLOCKS_PER_SM in calib/kernels.py
constexpr int kMaxEntries = 64;      // BIN_COUNT_MAX_ENTRIES
constexpr int kRingDepth = 8;        // BIN_COUNT_DEPTH: 16-byte words in flight per thread
constexpr int kMaxDevices = 64;

struct Entry {                  // BinCountEntry in calib/build.py
  const void* x;                // batch rows of n elements, contiguous
  unsigned long long* out;      // bins int64 counts, added into
  int64_t n;
  int64_t first;                // the entry's first element in the launch's flat range
  int t;                        // the entry's scale: scales[t]
};

struct Table {
  Entry e[kMaxEntries];
};

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

__device__ __forceinline__ int bucket(float v, float scale, int bins) {
  return min(max(__float2int_rz(__fmul_rn(fabsf(v), scale)), 0), bins - 1);
}

// Counts bucket b (b < 0: no element).
__device__ __forceinline__ void tally(int b, int* hist, int& zeros) {
  zeros += b == 0;
  if (b > 0) atomicAdd(hist + b, 1);
}

// Tallies the `count` elements at src, a run of valid rows of one entry in
// the block's range.  Thread t takes the run's 16-byte words t, t +
// kThreads, ...  With kDepth > 0 (a power of 2) each word is copied from
// device memory into the thread's own slot of the ring by cp.async, kDepth
// words ahead of the word the thread counts.  A thread reads only slots it
// filled itself, after waiting for its own copies, so no barrier is
// needed, and every copy it issues is waited for before the run ends.
// Every loop trip is uniform across the block.
template <int kDepth, typename T>
__device__ __forceinline__ void run(const T* src, int64_t count, float scale, int bins, int* hist,
                                    int& zeros, uint4* ring) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t begin = reinterpret_cast<uintptr_t>(src);
  const uintptr_t end = reinterpret_cast<uintptr_t>(src + count);
  const uintptr_t lo = begin & ~uintptr_t{15};
  const uintptr_t hi = (end + 15) & ~uintptr_t{15};
  const int64_t words_n = static_cast<int64_t>((hi - lo) / 16);
  const int head = static_cast<int>((begin - lo) / sizeof(T));       // word 0's elements before src
  const int tail = kVec - static_cast<int>((hi - end) / sizeof(T));  // the last word's elements in the run
  const uint4* words = reinterpret_cast<const uint4*>(lo);
  uint4* slot = ring + threadIdx.x;
  if constexpr (kDepth > 0) {
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      const int64_t w = static_cast<int64_t>(s) * kThreads + threadIdx.x;
      if (w < words_n) __pipeline_memcpy_async(slot + s * kThreads, words + w, 16);
      __pipeline_commit();
    }
  }
  const int64_t steps = (words_n + kThreads - 1) / kThreads;
  for (int64_t i = 0; i < steps; ++i) {
    const int64_t w = i * kThreads + threadIdx.x;
    uint4 raw = {0u, 0u, 0u, 0u};
    if constexpr (kDepth > 0) {
      __pipeline_wait_prior(kDepth - 1);  // this thread's copy of word w has landed
      raw = slot[static_cast<int>(i & (kDepth - 1)) * kThreads];
    } else {
      if (w < words_n) raw = __ldg(words + w);
    }
    float v[kVec];
    unpack(raw, v);
    const int k0 = w == 0 ? head : 0;
    const int k1 = w == words_n - 1 ? tail : (w < words_n ? kVec : 0);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      tally(k >= k0 && k < k1 ? bucket(v[k], scale, bins) : -1, hist, zeros);
    if constexpr (kDepth > 0) {
      // the slot's value is counted, so the next copy may overwrite it
      const int64_t next = w + static_cast<int64_t>(kDepth) * kThreads;
      if (next < words_n)
        __pipeline_memcpy_async(slot + static_cast<int>(i & (kDepth - 1)) * kThreads,
                                words + next, 16);
      __pipeline_commit();
    }
  }
}

// Adds the block's counts (the register-held zeros included) into out and
// leaves every shared counter zero.  Called by the whole block.
__device__ __forceinline__ void flush(int* hist, int bins, int& zeros, unsigned long long* out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) zeros += __shfl_xor_sync(0xffffffffu, zeros, o);
  if ((threadIdx.x & 31) == 0 && zeros) atomicAdd(hist, zeros);
  zeros = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    const int c = hist[b];
    hist[b] = 0;
    if (c) atomicAdd(out + b, static_cast<unsigned long long>(c));
  }
  __syncthreads();
}

// Shared memory: the ring of kDepth words per thread, then the histogram.
template <int kDepth>
constexpr int kRingBytes = kDepth * kThreads * 16;

template <typename T, int kDepth>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bin_count_kernel(const __grid_constant__ Table table, int count, int64_t batch, int64_t total,
                 int64_t per_block, int bins, const float* __restrict__ valid,
                 const float* __restrict__ scales) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  int* hist = reinterpret_cast<int*>(smem + kRingBytes<kDepth>);
  for (int i = threadIdx.x; i < bins; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t hi = min(lo + per_block, total);
  int zeros = 0;
  for (int k = 0; k < count; ++k) {
    const Entry& e = table.e[k];
    const int64_t a = max(lo - e.first, int64_t{0});
    const int64_t z = min(hi - e.first, batch * e.n);
    if (a >= z) continue;
    const float scale = scales[e.t];
    const T* x = static_cast<const T*>(e.x);
    bool counted = false;
    for (int64_t row = a / e.n; row * e.n < z;) {
      if (!(valid[row] > 0.f)) {
        ++row;
        continue;
      }
      int64_t stop = row + 1;  // the run of valid rows from `row` on
      while (stop * e.n < z && valid[stop] > 0.f) ++stop;
      const int64_t c0 = max(a, row * e.n);
      const int64_t c1 = min(z, stop * e.n);
      run<kDepth>(x + c0, c1 - c0, scale, bins, hist, zeros, ring);
      counted = true;
      row = stop;
    }
    if (counted) flush(hist, bins, zeros, e.out);
  }
}

template <typename T, int kDepth>
int launch(const Entry* entries, int count, int64_t batch, int64_t total, int64_t per_block,
           int grid, int bins, const float* valid, const float* scales, cudaStream_t stream,
           int device) {
  Table table = {};
  for (int i = 0; i < count; ++i) table.e[i] = entries[i];
  const size_t smem = kRingBytes<kDepth> + static_cast<size_t>(bins) * sizeof(int);
  // the shared memory this kernel may have, as granted on each device so far
  static size_t granted[kMaxDevices] = {};
  const bool known = device < kMaxDevices && smem <= granted[device];
  if (!known) {
    cudaError_t err = cudaFuncSetAttribute(bin_count_kernel<T, kDepth>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so no later launch check reports it
      return static_cast<int>(err);
    }
    if (device < kMaxDevices) granted[device] = smem;
  }
  bin_count_kernel<T, kDepth><<<grid, kThreads, smem, stream>>>(table, count, batch, total,
                                                                per_block, bins, valid, scales);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_depth(int depth, const Entry* e, int count, int64_t batch, int64_t total,
                 int64_t per_block, int grid, int bins, const float* valid, const float* scales,
                 cudaStream_t s, int d) {
  if (depth == kRingDepth)
    return launch<T, kRingDepth>(e, count, batch, total, per_block, grid, bins, valid, scales, s,
                                 d);
  if (depth == 0)
    return launch<T, 0>(e, count, batch, total, per_block, grid, bins, valid, scales, s, d);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// entries: `count` (1..kMaxEntries) tensors of one dtype (0 = f32, 1 = bf16),
// each (batch, n) contiguous, laid end to end in a flat range of `total`
// elements; block b of `grid` counts [b * per_block, (b + 1) * per_block).
// valid: (batch,) f32; scales: f32, read at each entry's t; each entry's
// out: (bins,) int64, added into.  depth: the ring's words per thread,
// kRingDepth, or 0 when the histogram leaves no room for the ring.
// Launches on `stream` of `device`, allocates nothing, returns
// cudaGetLastError(), or cudaFuncSetAttribute's error when the ring and the
// histogram exceed a block's shared memory.
extern "C" int bin_count_launch(const void* entries, int count, int dtype, int depth,
                                long long batch, long long total, long long per_block, int grid,
                                int bins, const void* valid, const void* scales, void* stream,
                                int device) {
  if (count < 1 || count > kMaxEntries || batch < 1 || bins < 1 || grid < 1 || per_block < 1 ||
      per_block > 0x7fffffffLL || static_cast<long long>(grid) * per_block < total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Entry* e = static_cast<const Entry*>(entries);
  const float* v = static_cast<const float*>(valid);
  const float* sc = static_cast<const float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_depth<float>(depth, e, count, batch, total, per_block, grid, bins, v, sc, s,
                               device);
  if (dtype == 1)
    return launch_depth<__nv_bfloat16>(depth, e, count, batch, total, per_block, grid, bins, v,
                                       sc, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}
