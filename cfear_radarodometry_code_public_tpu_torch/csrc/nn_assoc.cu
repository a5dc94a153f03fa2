// Exact 1-NN association kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU Pallas kernels
//   A  cfear_radarodometry_code_public_tpu/ops/pallas_assoc.py:nn_min
//      (_nn_kernel): dense 1-NN per keyframe;
//   C  cfear_radarodometry_code_public_tpu/ops/pallas_assoc.py:nn_min_sparse
//      (_nn_sparse_kernel): the same, skipping (256-row source tile, 512-row
//      target tile) pairs whose bounding boxes are farther apart than the
//      association radius.
//
// Both take a leading lane axis, so one launch serves a whole batched step:
//   src (B, Msrc, 2) f32, tar (B, S, M, 2) f32, valid (B, S, M) u8
//   -> nn (B, S, Msrc) i32, d2 (B, S, Msrc) f32.
//
// Contract (identical to the plain PyTorch twins in ops/cuda_assoc.py, bit
// for bit): d2 = (sx-tx)^2 + (sy-ty)^2 in the difference form, each
// operation rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn keep nvcc from
// contracting into an FMA, which would move d2 by an ulp and flip near-tie
// argmins); +inf for invalid targets; targets scanned in index order with a
// strict '<' so the lowest index wins ties, as argmin does; rows with no
// valid (or no unskipped) target report (+inf, 0).
//
// What bounds them on an H100: at the CFEAR-3 bench shape (B=8, S=4,
// M=Msrc=1024) one call is ~34 M distance evaluations, microseconds of ALU
// work spread over 256 (A) or 128 (C) blocks — fewer blocks than a full
// wave of 132 SMs x several resident blocks. The calls are bound by launch
// latency and by the short grid, not by bytes (~0.2 MB read) or FLOPs. The
// design is the simple one: one source row per thread, the keyframe's
// targets staged through shared memory in chunks so every thread reads the
// same target (a broadcast, no bank conflicts). Fusing the attribute gather
// (TPU kernel E) and batching several outer iterations are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreadsA = 128;   // source rows per block, kernel A
constexpr int kChunkA = 1024;    // targets staged per shared-memory pass (12 KB)
constexpr int kTileS = 256;      // source rows per block, kernel C
constexpr int kTileT = 512;      // target rows per skip-test granule, kernel C

__device__ __forceinline__ float dist2(float sx, float sy, float tx, float ty) {
  const float dx = __fsub_rn(sx, tx);
  const float dy = __fsub_rn(sy, ty);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Kernel A. grid (B*S, ceil(Msrc / kThreadsA)), block kThreadsA.
__global__ void nn_min_kernel(const float* __restrict__ src,
                              const float* __restrict__ tar,
                              const unsigned char* __restrict__ valid,
                              int S, int Msrc, int M,
                              int* __restrict__ nn, float* __restrict__ d2) {
  __shared__ float sh_x[kChunkA];
  __shared__ float sh_y[kChunkA];
  __shared__ unsigned char sh_v[kChunkA];
  const int bs = blockIdx.x;               // lane * S + keyframe
  const int lane = bs / S;
  const int row = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = row < Msrc;
  float sx = 0.f, sy = 0.f;
  if (active) {
    sx = src[(static_cast<size_t>(lane) * Msrc + row) * 2];
    sy = src[(static_cast<size_t>(lane) * Msrc + row) * 2 + 1];
  }
  const float* t = tar + static_cast<size_t>(bs) * M * 2;
  const unsigned char* v = valid + static_cast<size_t>(bs) * M;
  float best = CUDART_INF_F;
  int barg = 0;
  for (int base = 0; base < M; base += kChunkA) {
    const int n = min(kChunkA, M - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      sh_x[k] = t[2 * (base + k)];
      sh_y[k] = t[2 * (base + k) + 1];
      sh_v[k] = v[base + k];
    }
    __syncthreads();
    if (active) {
      for (int k = 0; k < n; ++k) {
        const float d = sh_v[k] ? dist2(sx, sy, sh_x[k], sh_y[k]) : CUDART_INF_F;
        if (d < best) {
          best = d;
          barg = base + k;
        }
      }
    }
  }
  if (active) {
    const size_t o = static_cast<size_t>(bs) * Msrc + row;
    nn[o] = barg;
    d2[o] = best;
  }
}

// Kernel C. grid (B*S, Msrc / kTileS), block kTileS.
// src_bounds (B, Msrc/kTileS, 4), tar_bounds (B, S, M/kTileT, 4) as
// [xmin, xmax, ymin, ymax] (empty tiles +inf/-inf, so they never pass);
// radius (B,). The gap test is uniform across the block, so skipping a
// target tile is a branch no thread diverges on.
__global__ void nn_min_sparse_kernel(const float* __restrict__ src,
                                     const float* __restrict__ src_bounds,
                                     const float* __restrict__ tar,
                                     const float* __restrict__ tar_bounds,
                                     const unsigned char* __restrict__ valid,
                                     const float* __restrict__ radius,
                                     int S, int Msrc, int M,
                                     int* __restrict__ nn,
                                     float* __restrict__ d2) {
  __shared__ float sh_x[kTileT];
  __shared__ float sh_y[kTileT];
  __shared__ unsigned char sh_v[kTileT];
  const int bs = blockIdx.x;
  const int lane = bs / S;
  const int tile = blockIdx.y;
  const int row = tile * kTileS + threadIdx.x;   // Msrc % kTileS == 0
  const int n_src_tiles = Msrc / kTileS;
  const int n_tar_tiles = M / kTileT;
  const float sx = src[(static_cast<size_t>(lane) * Msrc + row) * 2];
  const float sy = src[(static_cast<size_t>(lane) * Msrc + row) * 2 + 1];
  const float* sb = src_bounds + (static_cast<size_t>(lane) * n_src_tiles + tile) * 4;
  const float sxmin = sb[0], sxmax = sb[1], symin = sb[2], symax = sb[3];
  const float r = radius[lane];
  const float r2 = __fmul_rn(r, r);
  const float* t = tar + static_cast<size_t>(bs) * M * 2;
  const unsigned char* v = valid + static_cast<size_t>(bs) * M;
  const float* tb = tar_bounds + static_cast<size_t>(bs) * n_tar_tiles * 4;
  float best = CUDART_INF_F;
  int barg = 0;
  for (int jt = 0; jt < n_tar_tiles; ++jt) {
    const float* b = tb + jt * 4;
    const float gapx = fmaxf(fmaxf(__fsub_rn(b[0], sxmax), __fsub_rn(sxmin, b[1])), 0.f);
    const float gapy = fmaxf(fmaxf(__fsub_rn(b[2], symax), __fsub_rn(symin, b[3])), 0.f);
    if (!(__fadd_rn(__fmul_rn(gapx, gapx), __fmul_rn(gapy, gapy)) <= r2)) continue;
    const int base = jt * kTileT;
    __syncthreads();
    for (int k = threadIdx.x; k < kTileT; k += blockDim.x) {
      sh_x[k] = t[2 * (base + k)];
      sh_y[k] = t[2 * (base + k) + 1];
      sh_v[k] = v[base + k];
    }
    __syncthreads();
    for (int k = 0; k < kTileT; ++k) {
      const float d = sh_v[k] ? dist2(sx, sy, sh_x[k], sh_y[k]) : CUDART_INF_F;
      if (d < best) {
        best = d;
        barg = base + k;
      }
    }
  }
  const size_t o = static_cast<size_t>(bs) * Msrc + row;
  nn[o] = barg;
  d2[o] = best;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
int cfear_nn_min(const float* src, const float* tar, const unsigned char* valid,
                 int B, int S, int Msrc, int M, int* nn, float* d2,
                 void* stream) {
  const dim3 grid(B * S, (Msrc + kThreadsA - 1) / kThreadsA);
  nn_min_kernel<<<grid, kThreadsA, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tar, valid, S, Msrc, M, nn, d2);
  return static_cast<int>(cudaGetLastError());
}

int cfear_nn_min_sparse(const float* src, const float* src_bounds,
                        const float* tar, const float* tar_bounds,
                        const unsigned char* valid, const float* radius,
                        int B, int S, int Msrc, int M, int* nn, float* d2,
                        void* stream) {
  const dim3 grid(B * S, Msrc / kTileS);
  nn_min_sparse_kernel<<<grid, kTileS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_bounds, tar, tar_bounds, valid, radius, S, Msrc, M, nn, d2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
