// Deterministic segment sum for Hopper (sm_90a), bound with ctypes.
//
// Replaces no TPU kernel: on the TPU, `jax.ops.segment_sum` is XLA's
// scatter. The port's `features.segment_sum` (the feature stage's voxel and
// moment sums, kernel G's plain twin, the loop closer's histograms, the
// pose graph's Hessian blocks) runs it for float32 rows on the card:
//
//   data (K, C) f32, ids (K,) int64, n
//   -> out (n, C) f32: out[s][c] = the data[r][c] of the rows r with
//      ids[r] == s, added one by one from 0.0f in ascending r.
//
// A row whose id lies outside [0, n) is dropped: its id is read, its data
// never. Adding in ascending row order is what the CPU's `index_add_` does,
// and what torch's deterministic `index_add_` on the card does (a stable
// sort of the ids, then each run of equal ids added in order) for rows of
// more than one column; for single columns it adds a run of 32 or more as
// a warp tree.
//
// What bounds it on an H100, and what the design does about it. The work
// that is needed is one read of the kept rows and one write of the output:
// at the feature stage's 512,000 rows of 63 columns into 430,592 segments,
// 93 MB and 108 MB, some 0.06 ms at 3.35 TB/s. Float atomics would do just
// that, in an order that changes from launch to launch. torch's
// deterministic route sorts the ids and then adds each run serially,
// reading and writing the output row in device memory for every input row;
// the feature stage sends its ~28% off-grid rows to one overflow segment,
// so one warp added ~143,000 rows in a chain. Here the rows are put in order
// per segment with integer counts, and each segment is then added by a
// group of threads with its loads in flight:
//  1. segsum_bucket_kernel: the segments are cut into tiles of T, and each
//     tile is one thread-block cluster of kCtas CTAs of W warps. Each warp
//     (a "part") owns a contiguous range of the K rows and reads their ids
//     twice, in ascending row order, 32 at a time, kBatch batches of loads
//     in flight. First it counts its rows in each of the tile's segments in
//     a count array of its own (shared memory), and its kept rows below the
//     tile. Then the cluster scans the counts (each CTA owns T/kCtas
//     segments and reads the other CTAs' totals through distributed shared
//     memory) into each part's first slot in each segment: segment by
//     segment, within a segment part by part, after every kept row of a
//     lower segment. Last, each warp writes each of its rows' indices to
//     its segment's next slot: equal ids of one batch are ranked by
//     __match_any_sync, and the batches go in row order, so every
//     segment's list comes out in ascending row order with no sort. Each
//     tile reads all K ids (from L2 after the first tile); `ends[s]` is the
//     end of segment s's list. Three cluster barriers, no device-memory
//     atomics, no scratch to zero between calls.
//  2. segsum_add_kernel: a group of g threads per segment, g the power of
//     two at or above min(C, kAddThreads), so one column a thread up to 256
//     columns: thread j adds columns j, j + g, ... of the listed rows from
//     0.0f with __fadd_rn in list order, kUnroll rows' loads in flight, and
//     writes them (0.0f for an empty segment).
// The tile size and the warps a CTA follow from n alone (`tile_shape`).
// No float atomics, no host sync: the same bits on every launch, and the
// same as the CPU's `index_add_`. Any segment length comes out right.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;                 // CTAs of a tile's cluster
constexpr int kTileMax = 4096;           // segments a tile
constexpr int kSmemBudget = 80 * 1024;   // count arrays of a CTA: 2 CTAs an SM
constexpr int kMaxWarps = 16;
constexpr int kBatch = 16;               // 32-row batches of ids in flight
constexpr int kAddThreads = 256;
constexpr int kUnroll = 8;               // rows in flight a thread
constexpr unsigned kFull = 0xffffffffu;

// Calls f(row, id) for the rows [lo, hi) in ascending order, 32 at a time
// (lane l takes row b + l); a lane past hi gets id -1, which no tile keeps.
// lo and hi are warp-uniform, so every lane makes every call.
template <class F>
__device__ __forceinline__ void for_each_row(const long long* __restrict__ ids,
                                             int lo, int hi, int l, F&& f) {
  for (int b0 = lo; b0 < hi; b0 += 32 * kBatch) {
    long long id[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = b0 + j * 32 + l;
      id[j] = r < hi ? __ldg(ids + r) : -1LL;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) f(b0 + j * 32 + l, id[j]);
  }
}

// Exclusive scan of one value per thread over the block; `total` gets the
// block's sum. `warp_tot` holds kMaxWarps ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int own, int* warp_tot,
                                                    int& total) {
  const int t = threadIdx.x;
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if ((t & 31) >= o) incl += y;
  }
  if ((t & 31) == 31) warp_tot[t >> 5] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int n = warp_tot[w];
    before += w < (t >> 5) ? n : 0;
    total += n;
  }
  return before + incl - own;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
segsum_bucket_kernel(const long long* __restrict__ ids, int K, int n, int T,
                     int* __restrict__ ends, int* __restrict__ keys) {
  // (W, T) each warp's rows in each of the tile's segments, then the next
  // free slot of its rows; then (T) the CTA's rows in each segment, then
  // the first slot of the CTA's rows
  extern __shared__ int cnt[];
  __shared__ int warp_tot[kMaxWarps];
  __shared__ int cta_below;   // the CTA's kept rows below the tile
  __shared__ int cta_total;   // rows in the segments this CTA owns
  cg::cluster_group cluster = cg::this_cluster();
  const int W = blockDim.x >> 5;
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long t0 = static_cast<long long>(blockIdx.x / kCtas) * T;
  const int tile = static_cast<int>(min(static_cast<long long>(T), n - t0));
  int* tot = cnt + W * T;
  int* mine = cnt + w * T;
  // this warp's rows
  const long long parts = static_cast<long long>(kCtas) * W;
  const long long share = (K + parts - 1) / parts;
  const int lo = static_cast<int>(min((rank * W + w) * share,
                                      static_cast<long long>(K)));
  const int hi = static_cast<int>(min(lo + share, static_cast<long long>(K)));
  for (int i = t; i < (W + 1) * T; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  // 1. this warp's rows per segment of the tile, and below it
  int below = 0;
  for_each_row(ids, lo, hi, l, [&](int, long long id) {
    const long long d = id - t0;
    if (d >= 0 && d < tile) {
      atomicAdd(&mine[d], 1);
    } else if (id >= 0 && id < t0) {
      ++below;
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
  if (l == 0) warp_tot[w] = below;
  __syncthreads();
  for (int s = t; s < tile; s += blockDim.x) {
    int sum = 0;
    for (int v = 0; v < W; ++v) sum += cnt[v * T + s];
    tot[s] = sum;
  }
  if (t == 0) {
    int b = 0;
    for (int v = 0; v < W; ++v) b += warp_tot[v];
    cta_below = b;
  }
  cluster.sync();

  // 2. first slots. This CTA owns segments [c_lo, c_hi), `per` consecutive
  // ones a thread: their rows over all CTAs, scanned over the block ...
  int base = 0;   // kept rows below the tile, over the cluster's parts
#pragma unroll
  for (int q = 0; q < kCtas; ++q) base += *cluster.map_shared_rank(&cta_below, q);
  const int c_share = (tile + kCtas - 1) / kCtas;
  const int c_lo = min(rank * c_share, tile);
  const int c_hi = min(c_lo + c_share, tile);
  const int per = (c_share + blockDim.x - 1) / blockDim.x;
  const int s_lo = min(c_lo + t * per, c_hi);
  const int s_hi = min(s_lo + per, c_hi);
  int own = 0;
  for (int s = s_lo; s < s_hi; ++s) {
#pragma unroll
    for (int q = 0; q < kCtas; ++q) own += cluster.map_shared_rank(tot, q)[s];
  }
  int total;
  int run = block_exclusive_scan(own, warp_tot, total);
  if (t == 0) cta_total = total;
  // ... and over the CTAs before this one
  cluster.sync();
  run += base;
  for (int q = 0; q < rank; ++q) run += *cluster.map_shared_rank(&cta_total, q);
  for (int s = s_lo; s < s_hi; ++s) {
    int m[kCtas];   // read all, then write: the reads overlap
#pragma unroll
    for (int q = 0; q < kCtas; ++q) m[q] = cluster.map_shared_rank(tot, q)[s];
#pragma unroll
    for (int q = 0; q < kCtas; ++q) {
      cluster.map_shared_rank(tot, q)[s] = run;
      run += m[q];
    }
    ends[t0 + s] = run;
  }
  cluster.sync();
  // each warp's first slot in each segment, after the CTA's earlier warps
  for (int s = t; s < tile; s += blockDim.x) {
    int r = tot[s];
    for (int v = 0; v < W; ++v) {
      const int c = cnt[v * T + s];
      cnt[v * T + s] = r;
      r += c;
    }
  }
  __syncthreads();

  // 3. each row's index to its segment's next slot, in row order
  const unsigned below_lane = (1u << l) - 1u;
  for_each_row(ids, lo, hi, l, [&](int r, long long id) {
    const long long d = id - t0;
    const bool in = d >= 0 && d < tile;
    const int s = in ? static_cast<int>(d) : -1;
    const unsigned peers = __match_any_sync(kFull, s);
    const int before = __popc(peers & below_lane);
    if (in) keys[mine[s] + before] = r;
    __syncwarp();
    if (in && before == 0) mine[s] += __popc(peers);
    __syncwarp();
  });
}

__global__ void __launch_bounds__(kAddThreads)
segsum_add_kernel(const float* __restrict__ data, const int* __restrict__ keys,
                  const int* __restrict__ ends, int n, int C, int log_g,
                  float* __restrict__ out) {
  const long long s = static_cast<long long>(blockIdx.x) * (kAddThreads >> log_g)
                      + (threadIdx.x >> log_g);
  if (s >= n) return;
  const int g = 1 << log_g;
  const int begin = s > 0 ? __ldg(ends + s - 1) : 0;
  const int end = __ldg(ends + s);
  const size_t stride = static_cast<size_t>(C);
  for (int c = threadIdx.x & (g - 1); c < C; c += g) {
    const float* col = data + c;
    float acc = 0.0f;
    int e = begin;
    for (; e + kUnroll <= end; e += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = __ldg(col + static_cast<size_t>(__ldg(keys + e + u)) * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; e < end; ++e)
      acc = __fadd_rn(acc, __ldg(col + static_cast<size_t>(__ldg(keys + e)) * stride));
    out[s * stride + c] = acc;
  }
}

// The tile of segments and the warps a CTA, from n alone: T = min(n,
// kTileMax), and as many warps (a count array each, and one for the CTA)
// as kSmemBudget holds, at most kMaxWarps.
void tile_shape(int n, int& T, int& W) {
  T = n < kTileMax ? n : kTileMax;
  W = kSmemBudget / (static_cast<int>(sizeof(int)) * T) - 1;
  W = W < 1 ? 1 : (W > kMaxWarps ? kMaxWarps : W);
}

}  // namespace

extern "C" {

// Two launches on `stream` (bucket, then add), no synchronisation; returns
// the first CUDA error (0 = both launched), 1 (cudaErrorInvalidValue) for
// shapes the kernels do not take. `keys` (max(K, 1)) and `ends` (n) are
// int32 scratch that need no initial value; `out` (n, C) is written whole.
int cfear_segment_sum(const float* data, const long long* ids, long long K,
                      long long C, long long n, int* keys, int* ends,
                      float* out, void* stream) {
  if (K < 0 || K > (1LL << 31) - 1 - 32 * kBatch || C < 1 || C > (1 << 30)
      || n < 1 || n > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int T, W;
  tile_shape(static_cast<int>(n), T, W);
  const long long tiles = (n + T - 1) / T;
  if (tiles * kCtas > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(W + 1) * T * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segsum_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * kCtas));
  config.blockDim = dim3(32 * W);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, segsum_bucket_kernel, ids, static_cast<int>(K),
      static_cast<int>(n), T, ends, keys);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  int log_g = 0;
  while ((1LL << log_g) < C && (1 << log_g) < kAddThreads) ++log_g;
  const long long per_block = kAddThreads >> log_g;
  const long long blocks = (n + per_block - 1) / per_block;
  segsum_add_kernel<<<static_cast<unsigned>(blocks), kAddThreads, 0, st>>>(
      data, keys, ends, static_cast<int>(n), static_cast<int>(C), log_g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
