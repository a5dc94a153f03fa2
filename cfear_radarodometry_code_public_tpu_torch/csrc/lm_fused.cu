// The whole trust-region Levenberg-Marquardt solve as one kernel for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the TPU Pallas kernel
//   F  cfear_radarodometry_code_public_tpu/ops/pallas_lm.py:lm_solve_fused
//      (_lm_kernel_ee, the early-exit variant, and _lm_kernel, the masked
//      always-max_itr variant).
//
// A lane's problem is the packed rows
//   packed (B, 8, N) f32, rows [sx, sy, mx, my, w, r5, r6, r7]
//   (P2P / P2D: r5..r7 = sqrt-information l11, l21, l22; P2L: nx, ny, 0),
//   pose0 (B, 3) f32  ->  out (B, 6) f32 [px, py, pt, cost, steps, last_rel]
//   (steps as the bits of an int32).
// The iteration is ops/lm.py's `_lm_funcs.body` (the reference's
// pallas_lm.py:157-197) step for step: damping, solve3, the model reduction,
// accept when rel > 1e-3 and the new cost is finite, the radius update and
// the four convergence tests.
//
// What bounds it on an H100, and what the design does about it. A solve is
// up to 21 passes over the lane's 32 x N bytes, each followed by a sum over
// the lane and a few dozen scalar operations that the next pass waits for.
// The arithmetic is microseconds; what costs is reading the rows again on
// every pass, through one SM, the latency of a row's chain of operations
// (a square root and a division per row) and the barriers between the
// sections. So:
//  - One pass per iteration. The plain loop evaluates the cost at the trial
//    pose and then, if the step is accepted, cost, gradient and Hessian
//    there. Here the trial pose gets all ten sums at once; a rejected step
//    (rare) throws nine of them away. The accepted cost is the same sum of
//    w * rho either way.
//  - A pass has no branch per row: the loss and the cost metric are template
//    arguments of the pass, chosen by one branch outside it, and the walk
//    is unrolled so that four rows' square roots and divisions overlap.
//  - The rows are read from device memory once, and a lane is more than one
//    SM when it is large: a thread-block cluster of C CTAs, C from N alone
//    (cluster_size: 1 below kClusterFrom rows, where a cluster
//    barrier costs more than the rows it saves; 8 from there on; 16 where
//    N exceeds 8 x kSmemRows, the rows 8 CTAs hold in shared memory at 32
//    bytes a row). CTA c copies rows [c * share, (c + 1) * share) into
//    shared memory before the first pass; every pass then reads shared
//    memory only. What a CTA's shared memory does not hold of its share
//    is streamed from L2 on every pass.
//  - Every thread keeps the LM state in registers and runs the scalar
//    sections itself, on the same sums and so to the same bits: no thread-0
//    section, no broadcast, no barrier around the 3x3 solve or the
//    acceptance tests.
//  - A sum over the lane is: per thread in row order; per block through a
//    transposed shared-memory tile (warp v adds column v in thread order);
//    per cluster by writing the block's totals into every CTA's shared
//    memory (distributed shared memory), one cluster barrier, and a fixed
//    tree over the CTA ranks. Two block barriers a sum for C = 1, one more
//    and the cluster barrier for C > 1. The order depends on N only, so a
//    lane's result does not depend on B or on the launch.
//
// early_exit != 0 is _lm_kernel_ee: `done` is uniform over the cluster and
// the loop breaks. early_exit = 0 is _lm_kernel: all max_itr iterations run
// and a converged state is frozen. The two give identical results. Cost
// metric, loss, loss limit, max_itr and function tolerance are
// arguments: one build serves every configuration. Rows with weight 0 are
// evaluated like any other (a non-finite row poisons the cost even with
// w = 0, as in the plain loop).
//
// Arithmetic is IEEE f32 with true division and sqrtf/sinf/cosf/logf/
// log1pf (no fast-math intrinsics); torch.clamp's NaN propagation is kept
// (clamp_min/clamp_max below) where fmaxf/fminf would drop a NaN.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 10;          // cost, 3 gradient, 6 Hessian entries
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
// Rows a CTA keeps in shared memory: 32 bytes each, beside 23 KB of
// reduction scratch, inside the 227 KB a block may use.
constexpr int kSmemRows = 6528;
// Lanes of fewer rows run in one CTA (see cluster_size).
constexpr int kClusterFrom = 4096;
constexpr unsigned kFull = 0xffffffffu;

enum Cost { kP2P = 0, kP2L = 1, kP2D = 2 };
enum Loss { kNone = 0, kHuber = 1, kCauchy = 2, kSoftLOne = 3, kTukey = 4,
            kCombined = 5, kDCS = 6 };

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;   // NaN stays NaN, as torch.clamp
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// Both branches are evaluated and one is selected, so that a pass has no
// branch per row; the selected values are those of the branching form.
__device__ __forceinline__ void huber(float s, float a, float& rho, float& drho) {
  const float b = a * a;
  const float sq = sqrtf(clamp_min(s, 1e-30f));
  const bool outlier = s > b;
  rho = outlier ? 2.0f * a * sq - b : s;
  drho = outlier ? a / sq : 1.0f;
}

__device__ __forceinline__ void cauchy(float s, float a, float& rho, float& drho) {
  const float b = a * a;
  rho = b * log1pf(s / b);
  drho = 1.0f / (1.0f + s / b);
}

// (rho(s), rho'(s)) with Ceres semantics, as ops/losses.py:rho. The loss is
// a template argument so that a pass over the rows has no branch on it and
// the compiler can overlap the rows' long operations (sqrt, division).
template <int kLoss>
__device__ __forceinline__ void robust(float s, float a, float& rho,
                                       float& drho) {
  if constexpr (kLoss == kHuber) {
    huber(s, a, rho, drho);
  } else if constexpr (kLoss == kCauchy) {
    cauchy(s, a, rho, drho);
  } else if constexpr (kLoss == kSoftLOne) {
    const float b = a * a;
    const float t = sqrtf(1.0f + s / b);
    rho = 2.0f * b * (t - 1.0f);
    drho = 1.0f / t;
  } else if constexpr (kLoss == kTukey) {
    const float b = a * a;
    const float t = clamp_min(1.0f - s / b, 0.0f);
    rho = b / 3.0f * (1.0f - t * t * t);
    drho = t * t;
  } else if constexpr (kLoss == kCombined) {
    // ceres::ComposedLoss(Huber(1), Cauchy(1))
    float g, dg, f, df;
    cauchy(s, 1.0f, g, dg);
    huber(g, 1.0f, f, df);
    rho = f;
    drho = df * dg;
  } else if constexpr (kLoss == kDCS) {
    const float sp = clamp_min(s, 0.0f);
    const float w = clamp_max(2.0f * a / (a + sp), 1.0f);
    rho = sp <= a ? sp : 3.0f * a - 4.0f * a * a / (a + sp);
    drho = w * w;
  } else {
    rho = s;
    drho = 1.0f;
  }
}

// This CTA's share of a lane's rows: the first n_sh in shared memory (row r
// at sh + r * n_sh), the rest [g_lo, g_hi) of the lane's N read from device
// memory (L2) on every pass. A thread walks its rows in index order.
struct Rows {
  const float* sh;
  int n_sh;
  const float* gl;   // the lane's (8, N) block
  int n, g_lo, g_hi;

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
#pragma unroll 4
    for (int k = threadIdx.x; k < n_sh; k += kThreads)
      f(sh[k], sh[n_sh + k], sh[2 * n_sh + k], sh[3 * n_sh + k],
        sh[4 * n_sh + k], sh[5 * n_sh + k], sh[6 * n_sh + k],
        sh[7 * n_sh + k]);
    const size_t n_ = static_cast<size_t>(n);
#pragma unroll 4
    for (int k = g_lo + threadIdx.x; k < g_hi; k += kThreads)
      f(__ldg(gl + k), __ldg(gl + n_ + k), __ldg(gl + 2 * n_ + k),
        __ldg(gl + 3 * n_ + k), __ldg(gl + 4 * n_ + k), __ldg(gl + 5 * n_ + k),
        __ldg(gl + 6 * n_ + k), __ldg(gl + 7 * n_ + k));
  }
};

// This thread's partial sums of [w*rho, g0..g2, h0..h5] (ops/lm.py cgh).
template <int kLoss, bool kP2L>
__device__ __noinline__ void cgh_rows(const Rows R, float limit, float px,
                                      float py, float pt, float* out) {
  const float c = cosf(pt), s = sinf(pt);
  float v[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) v[i] = 0.0f;
  R.for_each([&](float sx, float sy, float mx, float my, float w, float r5,
                 float r6, float r7) {
    const float dx = c * sx - s * sy + px - mx;
    const float dy = s * sx + c * sy + py - my;
    const float jx = -s * sx - c * sy;   // d(tx)/dtheta
    const float jy = c * sx - s * sy;    // d(ty)/dtheta
    float rho, drho;
    if constexpr (kP2L) {
      const float e = dx * r5 + dy * r6;
      robust<kLoss>(e * e, limit, rho, drho);
      const float wd = w * drho;
      const float jt = r5 * jx + r6 * jy;
      v[0] += w * rho;
      v[1] += wd * r5 * e;
      v[2] += wd * r6 * e;
      v[3] += wd * jt * e;
      v[4] += wd * r5 * r5;
      v[5] += wd * r5 * r6;
      v[6] += wd * r5 * jt;
      v[7] += wd * r6 * r6;
      v[8] += wd * r6 * jt;
      v[9] += wd * jt * jt;
    } else {
      const float e0 = r5 * dx;
      const float e1 = r6 * dx + r7 * dy;
      robust<kLoss>(e0 * e0 + e1 * e1, limit, rho, drho);
      const float wd = w * drho;
      const float j0t = r5 * jx;
      const float j1t = r6 * jx + r7 * jy;
      v[0] += w * rho;
      v[1] += wd * (r5 * e0 + r6 * e1);
      v[2] += wd * (r7 * e1);
      v[3] += wd * (j0t * e0 + j1t * e1);
      v[4] += wd * (r5 * r5 + r6 * r6);
      v[5] += wd * (r6 * r7);
      v[6] += wd * (r5 * j0t + r6 * j1t);
      v[7] += wd * (r7 * r7);
      v[8] += wd * (r7 * j1t);
      v[9] += wd * (j0t * j0t + j1t * j1t);
    }
  });
#pragma unroll
  for (int i = 0; i < kSums; ++i) out[i] = v[i];
}

// A pass for a cost metric and loss known only at run time: one uniform
// branch a pass, outside the walk over the rows. `f` is called with the
// loss as a compile-time constant.
template <class F>
__device__ __forceinline__ void with_loss(int loss, F&& f) {
  switch (loss) {
    case kHuber: f(std::integral_constant<int, kHuber>{}); break;
    case kCauchy: f(std::integral_constant<int, kCauchy>{}); break;
    case kSoftLOne: f(std::integral_constant<int, kSoftLOne>{}); break;
    case kTukey: f(std::integral_constant<int, kTukey>{}); break;
    case kCombined: f(std::integral_constant<int, kCombined>{}); break;
    case kDCS: f(std::integral_constant<int, kDCS>{}); break;
    default: f(std::integral_constant<int, kNone>{}); break;
  }
}

__device__ __forceinline__ void cgh_pass(const Rows& R, int cost, int loss,
                                         float limit, float px, float py,
                                         float pt, float (&v)[kSums]) {
  with_loss(loss, [&](auto tag) {
    constexpr int kLoss = decltype(tag)::value;
    if (cost == kP2L)
      cgh_rows<kLoss, true>(R, limit, px, py, pt, v);
    else
      cgh_rows<kLoss, false>(R, limit, px, py, pt, v);
  });
}

// Reduction scratch of one CTA.
struct Scratch {
  float part[kSums][kThreads];       // thread partials, one column per sum
  float peer[2][kMaxCluster][kSums]; // block totals by CTA rank, two parities
  float tot[kSums];                  // the lane's totals
};

// The lane's totals of V per-thread values, in every thread of every CTA of
// the cluster, in a fixed order: warp v adds column v of the tile (each of
// its lanes its 16 rows in thread order, then a butterfly over the lanes),
// and the blocks' totals are added in a butterfly over the CTA ranks.
// `parity` alternates between calls so that a CTA may write the next sum's
// totals into a peer that is still reading this one's.
template <int V>
__device__ __forceinline__ void lane_sum(float (&v)[V], Scratch& S, int C,
                                         int& parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) S.part[i][threadIdx.x] = v[i];
  __syncthreads();
  if (warp < V) {
    float a = S.part[warp][lane];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) a += S.part[warp][j * 32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    if (C == 1) {
      if (lane == 0) S.tot[warp] = a;
    } else if (lane < C) {
      cg::cluster_group cluster = cg::this_cluster();
      float* slot = &S.peer[parity][cluster.block_rank()][warp];
      *cluster.map_shared_rank(slot, lane) = a;
    }
  }
  if (C > 1) {   // uniform over the cluster
    cg::this_cluster().sync();
    if (warp < V) {
      float a = lane < C ? S.peer[parity][lane][warp] : 0.0f;
      for (int o = C / 2; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
      if (lane == 0) S.tot[warp] = a;
    }
    parity ^= 1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = S.tot[i];
}

__global__ void __launch_bounds__(kThreads)
lm_solve_kernel(const float* __restrict__ packed, const float* __restrict__ pose0,
                int n, int n_sh, int cost, int loss, float limit, int max_itr,
                float ftol, int early_exit, float* __restrict__ out) {
  extern __shared__ float sh_rows[];   // (8, n_sh)
  __shared__ Scratch S;
  const int lane = blockIdx.y;
  const int rank = blockIdx.x;         // the CTA's rank in its cluster
  const int C = gridDim.x;             // the cluster is the grid's x extent
  const float* base = packed + static_cast<size_t>(lane) * 8 * n;
  const int share = (n + C - 1) / C;
  const int lo = min(rank * share, n);
  const int hi = min(lo + share, n);
  const int held = min(hi - lo, n_sh);
  for (int r = 0; r < 8; ++r) {
    const float* row = base + static_cast<size_t>(r) * n + lo;
    for (int k = threadIdx.x; k < held; k += kThreads)
      sh_rows[r * held + k] = __ldg(row + k);
  }
  const Rows R{sh_rows, held, base, n, lo + held, hi};
  if (C > 1) {
    cg::this_cluster().sync();   // every CTA runs before a peer writes to it
  } else {
    __syncthreads();
  }

  int parity = 0;
  float px = pose0[lane * 3], py = pose0[lane * 3 + 1], pt = pose0[lane * 3 + 2];
  float cst, g0, g1, g2, hxx, hxy, hxt, hyy, hyt, htt;
  {
    float v[kSums];
    cgh_pass(R, cost, loss, limit, px, py, pt, v);
    lane_sum<kSums>(v, S, C, parity);
    cst = 0.5f * v[0];
    g0 = v[1], g1 = v[2], g2 = v[3];
    hxx = v[4], hxy = v[5], hxt = v[6], hyy = v[7], hyt = v[8], htt = v[9];
  }
  float radius = 1e4f, dec = 2.0f, lastrel = CUDART_INF_F;
  int steps = 0;
  bool done = false;

  for (int it = 0; it < max_itr; ++it) {
    if (early_exit && done) break;   // uniform over the cluster

    // --- trial step: damped 3x3 solve ---------------------------------------
    const float axx = hxx + fminf(fmaxf(hxx, 1e-6f), 1e32f) / radius;
    const float ayy = hyy + fminf(fmaxf(hyy, 1e-6f), 1e32f) / radius;
    const float att = htt + fminf(fmaxf(htt, 1e-6f), 1e32f) / radius;
    const float b0 = -g0, b1 = -g1, b2 = -g2;
    const float c00 = ayy * att - hyt * hyt;
    const float c01 = hxt * hyt - hxy * att;
    const float c02 = hxy * hyt - hxt * ayy;
    const float c11 = axx * att - hxt * hxt;
    const float c12 = hxy * hxt - axx * hyt;
    const float c22 = axx * ayy - hxy * hxy;
    const float det = axx * c00 + hxy * c01 + hxt * c02;
    const float inv_det = 1.0f / (fabsf(det) > 1e-30f ? det : 1e-30f);
    const float sx = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det;
    const float sy = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det;
    const float sth = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det;
    const float npx = px + sx, npy = py + sy, npt = pt + sth;

    // --- cost, gradient and Hessian at the trial pose ------------------------
    float v[kSums];
    cgh_pass(R, cost, loss, limit, npx, npy, npt, v);
    lane_sum<kSums>(v, S, C, parity);
    const float new_cost = 0.5f * v[0];

    // --- model reduction, acceptance, radius, convergence -------------------
    const float gd = g0 * sx + g1 * sy + g2 * sth;
    const float hd0 = hxx * sx + hxy * sy + hxt * sth;
    const float hd1 = hxy * sx + hyy * sy + hyt * sth;
    const float hd2 = hxt * sx + hyt * sy + htt * sth;
    const float model_red = -(gd + 0.5f * (sx * hd0 + sy * hd1 + sth * hd2));
    const float rel = (cst - new_cost) / clamp_min(model_red, 1e-30f);
    const bool accept = (rel > 1e-3f) && isfinite(new_cost);
    const float t = 2.0f * rel - 1.0f;
    const float shrink = 1.0f - t * t * t;
    const float r_ok = radius / clamp_min(clamp_min(shrink, 1.0f / 3.0f), 1e-3f);
    const float r_bad = radius / dec;
    const bool func_conv = fabsf(cst - new_cost) <= ftol * cst;
    const bool pred_conv = model_red <= ftol * cst;
    const float stepn = sqrtf(sx * sx + sy * sy + sth * sth);
    const float posen = sqrtf(px * px + py * py + pt * pt);
    const bool step_small = stepn <= 1e-8f * (posen + 1e-8f);
    const bool new_done = (accept && func_conv) || pred_conv || step_small
                          || (r_bad < 1e-32f);

    // --- commit; a lane that was already done keeps its state ---------------
    if (!done) {
      if (accept) {
        px = npx, py = npy, pt = npt;
        cst = new_cost;
        g0 = v[1], g1 = v[2], g2 = v[3];
        hxx = v[4], hxy = v[5], hxt = v[6], hyy = v[7], hyt = v[8], htt = v[9];
        steps += 1;
      }
      radius = accept ? clamp_max(r_ok, 1e16f) : r_bad;
      dec = accept ? 2.0f : dec * 2.0f;
      lastrel = rel;
      done = new_done;
    }
  }

  if (rank == 0 && threadIdx.x == 0) {
    float* o = out + lane * 6;
    o[0] = px;
    o[1] = py;
    o[2] = pt;
    o[3] = cst;
    o[4] = __int_as_float(steps);   // read back as int32
    o[5] = lastrel;
  }
}

cudaError_t launch(const float* packed, const float* pose0, int B, int N,
                   int C, int n_sh, int cost, int loss, float limit,
                   int max_itr, float ftol, int early_exit, float* out,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_sh) * 8 * sizeof(float);
  // 1 + the most dynamic shared memory the kernel has been allowed so far
  // on each device (the attribute is per device); 0 = not set yet
  static int allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= kMaxDevices) {
    cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  }
  if (static_cast<int>(smem) >= allowed[device]) {
    err = cudaFuncSetAttribute(
        lm_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess && allowed[device] == 0)   // clusters of 16 CTAs
      err = cudaFuncSetAttribute(
          lm_solve_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) {
      cudaGetLastError();   // the refusal is reported, not left pending
      return err;
    }
    allowed[device] = static_cast<int>(smem) + 1;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(C, B);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, lm_solve_kernel, packed, pose0, N, n_sh, cost, loss, limit,
      max_itr, ftol, early_exit, out);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The cluster size the kernel takes for a lane of N rows, from N alone: one
// CTA below kClusterFrom rows (a cluster's barrier costs more than the rows
// it would save), 8 CTAs from there on, and 16 where 8 CTAs' shared memory
// does not hold the lane's rows.
int cluster_size(int N) {
  if (N < kClusterFrom) return 1;
  return N <= 8 * kSmemRows ? 8 : kMaxCluster;
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns the launch's CUDA
// error (0 = launched). `cluster` and `smem_rows` are 0 for the kernel's own
// choice (cluster_size(N); as many of a CTA's rows as fit); a
// measurement may force a cluster size of 1, 2, 4, 8 or 16 and the rows a
// CTA keeps in shared memory. A launch the card refuses (more shared memory
// than a block may have) returns its error and runs nothing.
int cfear_lm_solve_fused(const float* packed, const float* pose0, int B, int N,
                         int cost, int loss, float limit, int max_itr,
                         float ftol, int early_exit, int cluster,
                         int smem_rows, float* out, void* stream) {
  const int C = cluster ? cluster : cluster_size(N);
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) || smem_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int share = (N + C - 1) / C;
  const int cap = smem_rows ? smem_rows : kSmemRows;
  return static_cast<int>(launch(
      packed, pose0, B, N, C, share < cap ? share : cap, cost, loss, limit,
      max_itr, ftol, early_exit, out, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
