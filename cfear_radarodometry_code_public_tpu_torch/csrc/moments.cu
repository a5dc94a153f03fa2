// Per-compact-cell feature moments for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU Pallas kernel
//   G  cfear_radarodometry_code_public_tpu/ops/pallas_features.py:
//      moment_accumulate (_moment_kernel)
// which the feature stage runs with feature.backend = "pallas".
//
//   pack (B, R, N) f32, rows [rx, ry, w, own_cx, own_cy, mem_0..n_off-1,
//        trank_0..n_off-1, pad...]: each point's offset from its own voxel
//        centre, its weight, its own voxel centre, and per neighbour offset
//        oi a 0/1 membership and the compact rank of the target voxel
//        (stored as f32; >= c_pre means "no target");
//   offsets (n_off, 2): metric neighbour offsets (dx*leaf, dy*leaf)
//   -> out (B, 16, c_pre) f32, rows [cnt, S0, S1x, S1y, Sxx, Sxy, Syy,
//        cnt*cx, cnt*cy, 0 x 7] per compact cell, the moments taken about
//        the TARGET voxel centre (rx - dx_m, ry - dy_m), as _moment_kernel.
// (The reference's x-slab bounds of its cell and point tiles are not read:
// no tile pair is visited here.)
//
// What bounds it on an H100, and what the design does about it. The TPU
// kernel contracts a one-hot (point, cell) matrix on the MXU, work in
// proportion to cell tiles x points. The work that is needed is in
// proportion to the hits, the (point, offset) pairs that have a target:
// a few per point, some 16 per occupied cell. A scatter with float atomics
// would do just that work, in an order that changes from run to run; each
// cell's sums must instead be taken in (point, offset) order, as the plain
// twin takes them. So the hits are first bucketed by cell with integer
// atomics (any order gives the same buckets), and each bucket is put in
// order before it is summed:
//  1. moment_fill_kernel, one thread-block cluster of kFillCluster CTAs
//     per lane (one block's shared-memory atomics and its chain of L2
//     round trips were the kernel's whole time). Each CTA takes an eighth
//     of the n_off x N target ranks (16 bytes a thread, kBatch loads in
//     flight) and counts its hits per cell in its own shared memory. Then
//     each CTA takes an eighth of the cells, reads their eight counts
//     through distributed shared memory, scans its cells' totals, learns
//     the other CTAs' totals, and writes back to every CTA the first slot
//     of that CTA's hits in each cell: cell by cell, and within a cell by
//     CTA rank. Last, each CTA reads its ranks again (L2) and writes each
//     hit's key, point * 32 + oi, to its cell's next free slot, counted in
//     its own shared memory. Three cluster barriers, no device-memory
//     atomics, no counters to zero between calls.
//  2. moment_sum_kernel, one warp per cell, 32 cells per block: the warp
//     sorts the cell's keys ascending (they are unique, so the order no
//     longer depends on step 1's atomics): each 32 keys in registers by a
//     bitonic network of shuffles, and a longer list by the merge levels
//     of the same network with every comparator ascending, which is valid
//     for any length: in shared memory up to kListCap keys, beyond that in
//     place in device memory (an L2 round trip a level). Then, 32 keys at a
//     time, each thread forms one hit's nine terms from the pack, and
//     threads 0-8 each add one column in key order. Any list length comes
//     out right; none is capped.
// No float atomics: every add is an __fadd_rn in (point, offset) order
// (nvcc cannot contract the __fmul_rn/__fadd_rn/__fsub_rn into FMAs), the
// same on every launch and for every B, bit-equal to the plain twin.
// The ranks are read twice (once from device memory), the pack rows of each
// hit once; what is left is latency: two dependent launches, and in the
// second a sort and a serial sum per cell.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFillThreads = 512;
constexpr int kFillCluster = 8;       // CTAs a lane
constexpr int kBatch = 5;             // 16-byte rank loads in flight a thread
constexpr int kSumWarps = 16;         // warps per block of moment_sum_kernel
constexpr int kCellsPerWarp = 2;
constexpr int kCellTile = kSumWarps * kCellsPerWarp;   // cells per block
constexpr int kListCap = 256;         // keys a warp sorts in shared memory
constexpr int kMaxOff = 25;           // neighbour offsets (noff <= 2)
constexpr int kOffBits = 5;           // key = point << kOffBits | oi
constexpr int kMoments = 16;          // output rows
constexpr int kUsed = 9;              // of which are sums
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoKey = 0x7fffffff;

// Calls f(rank, index into the lane's n_off x N ranks) for the ranks
// [4 * q_lo, 4 * q_hi) of the lane, kBatch 16-byte loads a thread in flight
// at a time.
template <class F>
__device__ __forceinline__ void for_each_rank(const float* trank, int q_lo,
                                              int q_hi, F&& f) {
  const float4* trank4 = reinterpret_cast<const float4*>(trank);
  for (int q0 = q_lo + threadIdx.x; q0 < q_hi; q0 += kFillThreads * kBatch) {
    float4 r[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + j * kFillThreads;
      r[j] = q < q_hi ? __ldg(trank4 + q) : make_float4(-1.f, -1.f, -1.f, -1.f);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = 4 * (q0 + j * kFillThreads);
      f(r[j].x, i);
      f(r[j].y, i + 1);
      f(r[j].z, i + 2);
      f(r[j].w, i + 3);
    }
  }
}

// Exclusive scan of one value per thread over the block; `total` gets the
// block's sum. `warp_tot` is kFillThreads / 32 ints of shared memory.
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
#pragma unroll
  for (int w = 0; w < kFillThreads / 32; ++w) {
    const int n = warp_tot[w];
    before += w < (t >> 5) ? n : 0;
    total += n;
  }
  return before + incl - own;
}

__global__ void __launch_bounds__(kFillThreads)
moment_fill_kernel(const float* __restrict__ pack, int R, int N, int n_off,
                   int c_pre, int* __restrict__ ends, int* __restrict__ keys) {
  // (c_pre): this CTA's hits per cell, then the next free slot of its hits
  extern __shared__ int slot[];
  __shared__ int warp_tot[kFillThreads / 32];
  __shared__ int cta_tot[kFillCluster];   // hits in each CTA's cells
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = blockIdx.y;
  const int rank = blockIdx.x;
  const int t = threadIdx.x;
  const int n_hit = n_off * N;
  const float* trank = pack + (static_cast<size_t>(lane) * R + 5 + n_off) * N;
  const float c_max = static_cast<float>(c_pre);   // ranks < 2^24: exact
  const int q_share = (n_hit / 4 + kFillCluster - 1) / kFillCluster;
  const int q_lo = min(rank * q_share, n_hit / 4);   // N % 4 == 0
  const int q_hi = min(q_lo + q_share, n_hit / 4);
  for (int c = t; c < c_pre; c += kFillThreads) slot[c] = 0;
  __syncthreads();

  // 1. this CTA's hits per cell
  for_each_rank(trank, q_lo, q_hi, [&](float r, int) {
    if (r >= 0.0f && r < c_max) atomicAdd(&slot[static_cast<int>(r)], 1);
  });
  cluster.sync();

  // 2. first slots. This CTA owns cells [c_lo, c_hi), `per` consecutive
  // ones a thread: their hits over all CTAs, scanned over the block ...
  const int c_share = (c_pre + kFillCluster - 1) / kFillCluster;
  const int c_lo = min(rank * c_share, c_pre);
  const int c_hi = min(c_lo + c_share, c_pre);
  const int per = (c_share + kFillThreads - 1) / kFillThreads;
  const int lo = min(c_lo + t * per, c_hi);
  const int hi = min(lo + per, c_hi);
  int own = 0;
  for (int c = lo; c < hi; ++c) {
#pragma unroll
    for (int j = 0; j < kFillCluster; ++j)
      own += cluster.map_shared_rank(slot, j)[c];
  }
  int total;
  int run = block_exclusive_scan(own, warp_tot, total);
  // ... and over the CTAs before this one
  if (t < kFillCluster) cluster.map_shared_rank(cta_tot, t)[rank] = total;
  cluster.sync();
  for (int j = 0; j < rank; ++j) run += cta_tot[j];
  int* lane_ends = ends + static_cast<size_t>(lane) * c_pre;
  for (int c = lo; c < hi; ++c) {
    int n[kFillCluster];   // read all, then write: the reads overlap
#pragma unroll
    for (int j = 0; j < kFillCluster; ++j)
      n[j] = cluster.map_shared_rank(slot, j)[c];
#pragma unroll
    for (int j = 0; j < kFillCluster; ++j) {
      cluster.map_shared_rank(slot, j)[c] = run;
      run += n[j];
    }
    lane_ends[c] = run;
  }
  cluster.sync();

  // 3. each hit's key to the next free slot of this CTA's hits in its cell
  int* lane_keys = keys + static_cast<size_t>(lane) * n_hit;
  for_each_rank(trank, q_lo, q_hi, [&](float r, int i) {
    if (r >= 0.0f && r < c_max) {
      const int oi = i / N;
      lane_keys[atomicAdd(&slot[static_cast<int>(r)], 1)] =
          ((i - oi * N) << kOffBits) | oi;
    }
  });
}

// 32 keys, one per thread of the warp, ascending by thread.
__device__ __forceinline__ int warp_sort(int key, int l) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(kFull, key, j);
      const bool up = (l & k) == 0;
      const bool low = (l & j) == 0;
      key = (low == up) ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// One ascending comparator of the merge levels: thread-private pair (i, p).
__device__ __forceinline__ void order_pair(int* list, int i, int p, int n) {
  if (p > i && p < n) {
    const int a = list[i], b = list[p];
    if (a > b) {
      list[i] = b;
      list[p] = a;
    }
  }
}

// The warp sorts list[0, n), n > 32, ascending in place (shared or device
// memory). Each 32 keys are sorted in registers; then the merge levels of a
// bitonic network in which every comparator puts the smaller key at the
// lower index (a level starts by comparing i with its mirror i ^ (k - 1)),
// so a list padded to a power of two with +inf needs no comparator that
// touches the padding.
__device__ __forceinline__ void sort_list(int* list, int n, int l) {
  for (int base = 0; base < n; base += 32) {
    const bool mine = base + l < n;
    const int key = warp_sort(mine ? list[base + l] : kNoKey, l);
    if (mine) list[base + l] = key;   // the padding sorts to the end
  }
  __syncwarp();
  for (int k = 64; k < 2 * n; k <<= 1) {
    for (int i = l; i < n; i += 32) order_pair(list, i, i ^ (k - 1), n);
    __syncwarp();
    for (int j = k >> 2; j > 0; j >>= 1) {
      for (int i = l; i < n; i += 32) order_pair(list, i, i ^ j, n);
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kSumWarps * 32)
moment_sum_kernel(const float* __restrict__ pack,
                  const float* __restrict__ offsets,
                  const int* __restrict__ ends, int* keys, int R, int N,
                  int n_off, int c_pre, float* __restrict__ out) {
  __shared__ int lists[kSumWarps][kListCap];
  __shared__ float terms[kSumWarps][kUsed][32];
  __shared__ float res[kUsed][kCellTile + 1];
  __shared__ float sh_off[2 * kMaxOff];
  const int lane = blockIdx.y;
  const int cell0 = blockIdx.x * kCellTile;
  const int warp = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  if (threadIdx.x < 2 * n_off) sh_off[threadIdx.x] = offsets[threadIdx.x];
  __syncthreads();
  const float* p = pack + static_cast<size_t>(lane) * R * N;
  const int* lane_ends = ends + static_cast<size_t>(lane) * c_pre;
  int* lane_keys = keys + static_cast<size_t>(lane) * n_off * N;
  const size_t n_ = static_cast<size_t>(N);
  // the ends of this warp's cells and of the cell before them, and the
  // keys of every short list, all loaded before the first cell is summed
  const int first = cell0 + warp * kCellsPerWarp;
  int my_end = 0;
  if (l <= kCellsPerWarp && first + l > 0) my_end = lane_ends[first + l - 1];
  int begin[kCellsPerWarp], len[kCellsPerWarp], short_key[kCellsPerWarp];
#pragma unroll
  for (int i = 0; i < kCellsPerWarp; ++i) {
    begin[i] = __shfl_sync(kFull, my_end, i);
    len[i] = __shfl_sync(kFull, my_end, i + 1) - begin[i];   // warp-uniform
    short_key[i] = len[i] <= 32 && l < len[i] ? lane_keys[begin[i] + l] : kNoKey;
  }

#pragma unroll
  for (int i = 0; i < kCellsPerWarp; ++i) {
    const int n = len[i];
    int* list = lane_keys + begin[i];
    if (n > 32) {
      if (n <= kListCap) {
        for (int e = l; e < n; e += 32) lists[warp][e] = list[e];
        list = lists[warp];
        __syncwarp();
      }
      sort_list(list, n, l);
    }
    float acc = 0.0f;   // threads 0-8: the cell's sum of column l
    for (int base = 0; base < n; base += 32) {
      const int m = min(32, n - base);
      int key;
      if (n <= 32) {
        key = warp_sort(short_key[i], l);
      } else {
        key = l < m ? list[base + l] : kNoKey;
      }
      if (l < m) {
        const int k = key >> kOffBits;
        const int oi = key & ((1 << kOffBits) - 1);
        const float rx = __ldg(p + k), ry = __ldg(p + n_ + k);
        const float w = __ldg(p + 2 * n_ + k);
        const float ocx = __ldg(p + 3 * n_ + k);
        const float ocy = __ldg(p + 4 * n_ + k);
        const float mem = __ldg(p + (5 + oi) * n_ + k);
        const float dxm = sh_off[2 * oi], dym = sh_off[2 * oi + 1];
        const float rxt = __fsub_rn(rx, dxm);
        const float ryt = __fsub_rn(ry, dym);
        const float wm = __fmul_rn(w, mem);
        const float wx = __fmul_rn(wm, rxt);
        const float wy = __fmul_rn(wm, ryt);
        terms[warp][0][l] = mem;
        terms[warp][1][l] = wm;
        terms[warp][2][l] = wx;
        terms[warp][3][l] = wy;
        terms[warp][4][l] = __fmul_rn(wx, rxt);
        terms[warp][5][l] = __fmul_rn(wx, ryt);
        terms[warp][6][l] = __fmul_rn(wy, ryt);
        terms[warp][7][l] = __fmul_rn(mem, __fadd_rn(ocx, dxm));
        terms[warp][8][l] = __fmul_rn(mem, __fadd_rn(ocy, dym));
      }
      __syncwarp();
      if (l < kUsed) {
        for (int e = 0; e < m; ++e) acc = __fadd_rn(acc, terms[warp][l][e]);
      }
      __syncwarp();
    }
    if (l < kUsed) res[l][warp * kCellsPerWarp + i] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kMoments * kCellTile;
       idx += kSumWarps * 32) {
    const int row = idx / kCellTile, c = idx % kCellTile;
    out[(static_cast<size_t>(lane) * kMoments + row) * c_pre + cell0 + c] =
        row < kUsed ? res[row][c] : 0.0f;
  }
}

}  // namespace

extern "C" {

// Two launches on `stream` (fill, then sum), no synchronisation; returns the
// first CUDA error (0 = both launched), 1 (cudaErrorInvalidValue) for shapes
// the kernels do not take. `ends` (B, c_pre) and `keys` (B, n_off * N) are
// int32 scratch that need no initial value.
int cfear_moment_accumulate(const float* pack, const float* offsets, int B,
                            int R, int N, int n_off, int c_pre, int* ends,
                            int* keys, float* out, void* stream) {
  if (c_pre % kCellTile || n_off > kMaxOff || R < 5 + 2 * n_off || N % 4
      || N > (1 << (31 - kOffBits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(c_pre) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moment_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kFillCluster, B);
  config.blockDim = dim3(kFillThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFillCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, moment_fill_kernel, pack, R, N,
                                       n_off, c_pre, ends, keys);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid(c_pre / kCellTile, B);
  moment_sum_kernel<<<grid, kSumWarps * 32, 0, s>>>(
      pack, offsets, ends, keys, R, N, n_off, c_pre, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
