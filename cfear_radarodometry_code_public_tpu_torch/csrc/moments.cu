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
//   ct_lo, ct_hi (B, c_pre/128): dilated x-slab of each 128-cell tile;
//   pt_lo, pt_hi (B, N/512): x-range of each 512-point tile;
//   offsets (n_off, 2): metric neighbour offsets (dx*leaf, dy*leaf)
//   -> out (B, 16, c_pre) f32, rows [cnt, S0, S1x, S1y, Sxx, Sxy, Syy,
//        cnt*cx, cnt*cy, 0 x 7] per compact cell, the moments taken about
//        the TARGET voxel centre (rx - dx_m, ry - dy_m), as _moment_kernel.
//
// Design. The TPU kernel contracts a one-hot (point, cell) matrix on the
// MXU; on Hopper that would be 128x redundant multiply-adds and, with
// atomics, an order that changes from run to run. Here one block of 128
// threads owns one (lane, 128-cell tile) and each thread owns one cell. The
// block walks the points in index order, 128 at a time: each thread takes
// one point, finds which of its n_off target ranks fall in the block's
// tile, and a block-wide prefix sum writes those (point, offset) entries to
// shared memory in (point, offset) order. Every thread then scans the short
// list and adds the entries of its own cell, reading the point's rows from
// global memory (L1). No atomics: each cell's sums are taken in point
// order, the same order on every launch and for every B. A (cell tile,
// point tile) pair whose x-slabs are disjoint is skipped, as
// pallas_features.py:122 does; the test is uniform across the block. Each
// accumulation is written with __fmul_rn/__fadd_rn/__fsub_rn so nvcc cannot
// contract it into an FMA: the sums are those of a sequential f32 loop in
// point order, like the plain twin's.
//
// What bounds it on an H100: at the slice's width (N = 8192 points,
// c_pre = 4608 cells, 9 offsets) a lane is 36 blocks, each reading all
// 8192 x 9 target ranks (288 KB per block, from L2) once, plus the rows of
// the few points that hit its tile; a chunk of 128 points is a dependent
// chain of rank loads, a prefix sum and two barriers, so the kernel is
// latency-bound, with ~0.8 MB of pack per lane read 36 times over from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kCT = 128;      // cells per block, one per thread
constexpr int kPT = 512;      // points per skip-test granule
constexpr int kChunk = 128;   // points per list pass, one per thread
constexpr int kMaxOff = 25;   // neighbour offsets (noff <= 2)
constexpr int kMoments = 16;  // output rows (9 used)

__global__ void __launch_bounds__(kCT)
moment_kernel(const float* __restrict__ pack, const float* __restrict__ ct_lo,
              const float* __restrict__ ct_hi, const float* __restrict__ pt_lo,
              const float* __restrict__ pt_hi, const float* __restrict__ offsets,
              int R, int N, int n_off, int c_pre, float* __restrict__ out) {
  // entry = (cell - first cell of the tile) << 16 | point in chunk << 5 | oi
  __shared__ int list[kChunk * kMaxOff];
  __shared__ int warp_sum[kChunk / 32];
  __shared__ float sh_off[2 * kMaxOff];
  const int tile = blockIdx.x;
  const int lane = blockIdx.y;
  const int t = threadIdx.x;
  const int n_ct = c_pre / kCT;
  const int n_pt = N / kPT;
  const float first = static_cast<float>(tile * kCT);   // ranks < 2^24: exact
  const float last = first + static_cast<float>(kCT);
  if (t < 2 * n_off) sh_off[t] = offsets[t];
  const float lo = ct_lo[lane * n_ct + tile];
  const float hi = ct_hi[lane * n_ct + tile];
  const float* p = pack + static_cast<size_t>(lane) * R * N;
  const float* trank = p + static_cast<size_t>(5 + n_off) * N;
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.0f;

  for (int j = 0; j < n_pt; ++j) {
    const float plo = pt_lo[lane * n_pt + j];
    const float phi = pt_hi[lane * n_pt + j];
    if (!(lo <= phi && hi >= plo)) continue;   // disjoint x-slabs
    for (int base = j * kPT; base < (j + 1) * kPT; base += kChunk) {
      // this thread's point: how many of its target ranks are in the tile
      const int pt_idx = base + t;
      int cnt = 0;
      for (int oi = 0; oi < n_off; ++oi) {
        const float r = __ldg(trank + static_cast<size_t>(oi) * N + pt_idx);
        cnt += (r >= first && r < last) ? 1 : 0;
      }
      // exclusive prefix sum over the block, in point order
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if ((t & 31) >= o) incl += y;
      }
      __syncthreads();   // the previous chunk's list has been read
      if ((t & 31) == 31) warp_sum[t >> 5] = incl;
      __syncthreads();
      int pos = incl - cnt;
      int total = 0;
#pragma unroll
      for (int w = 0; w < kChunk / 32; ++w) {
        pos += w < (t >> 5) ? warp_sum[w] : 0;
        total += warp_sum[w];
      }
      if (cnt) {
        for (int oi = 0; oi < n_off; ++oi) {
          const float r = __ldg(trank + static_cast<size_t>(oi) * N + pt_idx);
          if (r >= first && r < last)
            list[pos++] = (static_cast<int>(r - first) << 16) | (t << 5) | oi;
        }
      }
      __syncthreads();
      for (int e = 0; e < total; ++e) {
        const int entry = list[e];
        if ((entry >> 16) != t) continue;
        const int k = base + ((entry >> 5) & (kChunk - 1));
        const int oi = entry & 31;
        const float rx = __ldg(p + k), ry = __ldg(p + N + k);
        const float w = __ldg(p + 2 * static_cast<size_t>(N) + k);
        const float ocx = __ldg(p + 3 * static_cast<size_t>(N) + k);
        const float ocy = __ldg(p + 4 * static_cast<size_t>(N) + k);
        const float mem = __ldg(p + static_cast<size_t>(5 + oi) * N + k);
        const float dxm = sh_off[2 * oi], dym = sh_off[2 * oi + 1];
        const float rxt = __fsub_rn(rx, dxm);
        const float ryt = __fsub_rn(ry, dym);
        const float wm = __fmul_rn(w, mem);
        const float wx = __fmul_rn(wm, rxt);
        const float wy = __fmul_rn(wm, ryt);
        acc[0] = __fadd_rn(acc[0], mem);
        acc[1] = __fadd_rn(acc[1], wm);
        acc[2] = __fadd_rn(acc[2], wx);
        acc[3] = __fadd_rn(acc[3], wy);
        acc[4] = __fadd_rn(acc[4], __fmul_rn(wx, rxt));
        acc[5] = __fadd_rn(acc[5], __fmul_rn(wx, ryt));
        acc[6] = __fadd_rn(acc[6], __fmul_rn(wy, ryt));
        acc[7] = __fadd_rn(acc[7], __fmul_rn(mem, __fadd_rn(ocx, dxm)));
        acc[8] = __fadd_rn(acc[8], __fmul_rn(mem, __fadd_rn(ocy, dym)));
      }
    }
  }
  float* o = out + static_cast<size_t>(lane) * kMoments * c_pre + tile * kCT + t;
#pragma unroll
  for (int i = 0; i < kMoments; ++i) o[static_cast<size_t>(i) * c_pre] = i < 9 ? acc[i] : 0.0f;
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched); 1 (cudaErrorInvalidValue) for shapes
// the kernel does not take.
int cfear_moment_accumulate(const float* pack, const float* ct_lo,
                            const float* ct_hi, const float* pt_lo,
                            const float* pt_hi, const float* offsets, int B,
                            int R, int N, int n_off, int c_pre, float* out,
                            void* stream) {
  if (N % kPT || c_pre % kCT || n_off > kMaxOff || R < 5 + 2 * n_off)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(c_pre / kCT, B);
  moment_kernel<<<grid, kCT, 0, static_cast<cudaStream_t>(stream)>>>(
      pack, ct_lo, ct_hi, pt_lo, pt_hi, offsets, R, N, n_off, c_pre, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
