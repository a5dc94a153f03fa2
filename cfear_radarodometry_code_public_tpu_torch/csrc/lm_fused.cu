// The whole trust-region Levenberg-Marquardt solve as one kernel for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the TPU Pallas kernel
//   F  cfear_radarodometry_code_public_tpu/ops/pallas_lm.py:lm_solve_fused
//      (_lm_kernel_ee, the early-exit variant, and _lm_kernel, the masked
//      always-max_itr variant).
//
// One CTA per lane solves that lane's problem over the packed rows
//   packed (B, 8, N) f32, rows [sx, sy, mx, my, w, r5, r6, r7]
//   (P2P / P2D: r5..r7 = sqrt-information l11, l21, l22; P2L: nx, ny, 0),
//   pose0 (B, 3) f32  ->  out (B, 6) f32 [px, py, pt, cost, steps, last_rel].
// The iteration is ops/lm.py's `_lm_funcs.body` (the reference's
// pallas_lm.py:157-197) step for step: damping, solve3, the model reduction,
// accept when rel > 1e-3 and the new cost is finite, the radius update and
// the four convergence tests. The LM scalars live in shared memory and are
// updated by thread 0; every thread strides over the rows for the two
// full-block passes of an iteration (cost at the trial pose; cost, gradient
// and Gauss-Newton Hessian at an accepted pose). Each pass sums per thread
// in row order and then over the block in a fixed shuffle tree, so a lane's
// result does not depend on B or on the launch.
//
// kEarlyExit = true is _lm_kernel_ee: `done` is read from shared memory by
// every thread and the loop breaks uniformly. kEarlyExit = false is
// _lm_kernel: all max_itr iterations run and a converged state is frozen.
// The two give identical results. Cost metric, loss, loss limit, max_itr and
// function tolerance are arguments: one build serves every configuration.
//
// What bounds it on an H100: at the slice's shape (B = 8, N = 4096) a solve
// is at most 20 iterations of two passes over 128 KB of rows; the work is
// microseconds, spread over only B blocks, so the kernel is latency-bound
// (a pass is a dependent chain of row loads, loss evaluation and a block
// reduction). What it removes is the plain loop's ~80 launches and one host
// sync per LM iteration. The rows are re-read from L2 on every pass; keeping
// them in shared memory, or splitting a lane over a thread-block cluster,
// is later work.
//
// Arithmetic is IEEE f32 with true division and sqrtf/sinf/cosf/logf/
// log1pf (no fast-math intrinsics); torch.clamp's NaN propagation is kept
// (clamp_min/clamp_max below) where fmaxf/fminf would drop a NaN.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

enum Cost { kP2P = 0, kP2L = 1, kP2D = 2 };
enum Loss { kNone = 0, kHuber = 1, kCauchy = 2, kSoftLOne = 3, kTukey = 4,
            kCombined = 5, kDCS = 6 };

// State slots in shared memory.
enum Slot {
  PX, PY, PT, COST, G0, G1, G2, H0, H1, H2, H3, H4, H5, RADIUS, DEC, ITR,
  STEPS, LASTREL, DONE,
  // per-iteration scratch written by thread 0
  SX, SY, ST, NPX, NPY, NPT, ACCEPT, NEW_DONE, REL, R_NEW, DEC_NEW,
  kSlots
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;   // NaN stays NaN, as torch.clamp
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

__device__ __forceinline__ void huber(float s, float a, float& rho, float& drho) {
  const float b = a * a;
  if (s > b) {
    const float sq = sqrtf(clamp_min(s, 1e-30f));
    rho = 2.0f * a * sq - b;
    drho = a / sq;
  } else {
    rho = s;
    drho = 1.0f;
  }
}

__device__ __forceinline__ void cauchy(float s, float a, float& rho, float& drho) {
  const float b = a * a;
  rho = b * log1pf(s / b);
  drho = 1.0f / (1.0f + s / b);
}

// (rho(s), rho'(s)) with Ceres semantics, as ops/losses.py:rho.
__device__ __forceinline__ void robust(int loss, float s, float a, float& rho,
                                       float& drho) {
  switch (loss) {
    case kHuber:
      huber(s, a, rho, drho);
      return;
    case kCauchy:
      cauchy(s, a, rho, drho);
      return;
    case kSoftLOne: {
      const float b = a * a;
      const float t = sqrtf(1.0f + s / b);
      rho = 2.0f * b * (t - 1.0f);
      drho = 1.0f / t;
      return;
    }
    case kTukey: {
      const float b = a * a;
      const float t = clamp_min(1.0f - s / b, 0.0f);
      rho = b / 3.0f * (1.0f - t * t * t);
      drho = t * t;
      return;
    }
    case kCombined: {   // ceres::ComposedLoss(Huber(1), Cauchy(1))
      float g, dg, f, df;
      cauchy(s, 1.0f, g, dg);
      huber(g, 1.0f, f, df);
      rho = f;
      drho = df * dg;
      return;
    }
    case kDCS: {
      const float sp = clamp_min(s, 0.0f);
      const float w = clamp_max(2.0f * a / (a + sp), 1.0f);
      rho = sp <= a ? sp : 3.0f * a - 4.0f * a * a / (a + sp);
      drho = w * w;
      return;
    }
    default:
      rho = s;
      drho = 1.0f;
  }
}

// Block sum of V values per thread in a fixed tree: shuffles inside each
// warp, then warp 0 over the warps' partials. Every thread gets the totals
// in `out` (shared memory).
template <int V>
__device__ __forceinline__ void block_sum(float (&v)[V], float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) red[warp * V + i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = lane < kWarps ? red[lane * V + i] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = v[i];
    }
  }
  __syncthreads();
}

struct Rows {
  const float* p;   // this lane's (8, N) block
  int n;
  __device__ __forceinline__ float at(int r, int k) const {
    return __ldg(p + static_cast<size_t>(r) * n + k);
  }
};

// Sum over rows of w * rho (the cost before the 0.5).
__device__ __forceinline__ float cost_rows(const Rows& R, int cost, int loss,
                                           float limit, float px, float py,
                                           float pt) {
  const float c = cosf(pt), s = sinf(pt);
  float acc = 0.0f;
  for (int k = threadIdx.x; k < R.n; k += kThreads) {
    const float sx = R.at(0, k), sy = R.at(1, k), mx = R.at(2, k),
                my = R.at(3, k), w = R.at(4, k), r5 = R.at(5, k),
                r6 = R.at(6, k), r7 = R.at(7, k);
    const float dx = c * sx - s * sy + px - mx;
    const float dy = s * sx + c * sy + py - my;
    float ssq;
    if (cost == kP2L) {
      const float e = dx * r5 + dy * r6;
      ssq = e * e;
    } else {
      const float e0 = r5 * dx;
      const float e1 = r6 * dx + r7 * dy;
      ssq = e0 * e0 + e1 * e1;
    }
    float rho, drho;
    robust(loss, ssq, limit, rho, drho);
    acc += w * rho;
  }
  return acc;
}

// Per-thread partial sums of [w*rho, g0..g2, h0..h5] (ops/lm.py cgh).
__device__ __forceinline__ void cgh_rows(const Rows& R, int cost, int loss,
                                         float limit, float px, float py,
                                         float pt, float (&v)[10]) {
  const float c = cosf(pt), s = sinf(pt);
#pragma unroll
  for (int i = 0; i < 10; ++i) v[i] = 0.0f;
  for (int k = threadIdx.x; k < R.n; k += kThreads) {
    const float sx = R.at(0, k), sy = R.at(1, k), mx = R.at(2, k),
                my = R.at(3, k), w = R.at(4, k), r5 = R.at(5, k),
                r6 = R.at(6, k), r7 = R.at(7, k);
    const float dx = c * sx - s * sy + px - mx;
    const float dy = s * sx + c * sy + py - my;
    const float jx = -s * sx - c * sy;   // d(tx)/dtheta
    const float jy = c * sx - s * sy;    // d(ty)/dtheta
    float rho, drho;
    if (cost == kP2L) {
      const float e = dx * r5 + dy * r6;
      robust(loss, e * e, limit, rho, drho);
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
      robust(loss, e0 * e0 + e1 * e1, limit, rho, drho);
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
  }
}

template <bool kEarlyExit>
__global__ void __launch_bounds__(kThreads)
lm_solve_kernel(const float* __restrict__ packed, const float* __restrict__ pose0,
                int n, int cost, int loss, float limit, int max_itr,
                float ftol, float* __restrict__ out) {
  __shared__ float red[kWarps * 10];
  __shared__ float sums[10];
  __shared__ float st[kSlots];
  const int lane = blockIdx.x;
  const Rows R{packed + static_cast<size_t>(lane) * 8 * n, n};
  const bool lead = threadIdx.x == 0;

  {
    const float px = pose0[lane * 3], py = pose0[lane * 3 + 1],
                pt = pose0[lane * 3 + 2];
    float v[10];
    cgh_rows(R, cost, loss, limit, px, py, pt, v);
    block_sum(v, red, sums);
    if (lead) {
      st[PX] = px;
      st[PY] = py;
      st[PT] = pt;
      st[COST] = 0.5f * sums[0];
      for (int i = 0; i < 3; ++i) st[G0 + i] = sums[1 + i];
      for (int i = 0; i < 6; ++i) st[H0 + i] = sums[4 + i];
      st[RADIUS] = 1e4f;
      st[DEC] = 2.0f;
      st[ITR] = 0.0f;
      st[STEPS] = 0.0f;
      st[LASTREL] = CUDART_INF_F;
      st[DONE] = 0.0f;
    }
    __syncthreads();
  }

  for (int it = 0; it < max_itr; ++it) {
    if (kEarlyExit && st[DONE] != 0.0f) break;   // uniform across the block

    // --- trial step: damped 3x3 solve (thread 0) ---------------------------
    if (lead) {
      const float hxx = st[H0], hxy = st[H1], hxt = st[H2], hyy = st[H3],
                  hyt = st[H4], htt = st[H5], radius = st[RADIUS];
      const float axx = hxx + fminf(fmaxf(hxx, 1e-6f), 1e32f) / radius;
      const float ayy = hyy + fminf(fmaxf(hyy, 1e-6f), 1e32f) / radius;
      const float att = htt + fminf(fmaxf(htt, 1e-6f), 1e32f) / radius;
      const float b0 = -st[G0], b1 = -st[G1], b2 = -st[G2];
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
      st[SX] = sx;
      st[SY] = sy;
      st[ST] = sth;
      st[NPX] = st[PX] + sx;
      st[NPY] = st[PY] + sy;
      st[NPT] = st[PT] + sth;
    }
    __syncthreads();

    // --- cost at the trial pose (all threads) ------------------------------
    {
      float v[1] = {cost_rows(R, cost, loss, limit, st[NPX], st[NPY], st[NPT])};
      block_sum(v, red, sums);
    }

    // --- model reduction, acceptance, radius, convergence (thread 0) -------
    if (lead) {
      const float new_cost = 0.5f * sums[0];
      const float cst = st[COST], radius = st[RADIUS], dec = st[DEC];
      const float sx = st[SX], sy = st[SY], sth = st[ST];
      const float hxx = st[H0], hxy = st[H1], hxt = st[H2], hyy = st[H3],
                  hyt = st[H4], htt = st[H5];
      const float gd = st[G0] * sx + st[G1] * sy + st[G2] * sth;
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
      const float px = st[PX], py = st[PY], pt = st[PT];
      const float posen = sqrtf(px * px + py * py + pt * pt);
      const bool step_small = stepn <= 1e-8f * (posen + 1e-8f);
      const bool new_done = (accept && func_conv) || pred_conv || step_small
                            || (r_bad < 1e-32f);
      st[ACCEPT] = accept ? 1.0f : 0.0f;
      st[NEW_DONE] = new_done ? 1.0f : 0.0f;
      st[REL] = rel;
      st[R_NEW] = accept ? clamp_max(r_ok, 1e16f) : r_bad;
      st[DEC_NEW] = accept ? 2.0f : dec * 2.0f;
    }
    __syncthreads();

    // --- cost, gradient and Hessian at an accepted pose (all threads) ------
    const bool accept = st[ACCEPT] != 0.0f;
    if (accept) {   // uniform: a rejected step keeps the old sums
      float v[10];
      cgh_rows(R, cost, loss, limit, st[NPX], st[NPY], st[NPT], v);
      block_sum(v, red, sums);
    }

    // --- commit; a lane that was already done keeps its state --------------
    if (lead && st[DONE] == 0.0f) {
      if (accept) {
        st[PX] = st[NPX];
        st[PY] = st[NPY];
        st[PT] = st[NPT];
        st[COST] = 0.5f * sums[0];
        for (int i = 0; i < 3; ++i) st[G0 + i] = sums[1 + i];
        for (int i = 0; i < 6; ++i) st[H0 + i] = sums[4 + i];
        st[STEPS] += 1.0f;
      }
      st[RADIUS] = st[R_NEW];
      st[DEC] = st[DEC_NEW];
      st[ITR] += 1.0f;
      st[LASTREL] = st[REL];
      st[DONE] = st[NEW_DONE];
    }
    __syncthreads();
  }

  if (lead) {
    float* o = out + lane * 6;
    o[0] = st[PX];
    o[1] = st[PY];
    o[2] = st[PT];
    o[3] = st[COST];
    o[4] = st[STEPS];
    o[5] = st[LASTREL];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
int cfear_lm_solve_fused(const float* packed, const float* pose0, int B, int N,
                         int cost, int loss, float limit, int max_itr,
                         float ftol, int early_exit, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (early_exit) {
    lm_solve_kernel<true><<<B, kThreads, 0, s>>>(packed, pose0, N, cost, loss,
                                                  limit, max_itr, ftol, out);
  } else {
    lm_solve_kernel<false><<<B, kThreads, 0, s>>>(packed, pose0, N, cost, loss,
                                                   limit, max_itr, ftol, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
