// Exact 1-NN association kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU Pallas kernels
//   A  cfear_radarodometry_code_public_tpu/ops/pallas_assoc.py:nn_min
//      (_nn_kernel): dense 1-NN per keyframe;
//   B1 pallas_assoc.py:nn_min_multi (_nn_multi_kernel): A's function with
//      the keyframe loop inside the kernel, at runtime;
//   B2 pallas_assoc.py:nn_min_multi_unrolled (_nn_multi_unrolled_kernel):
//      A's function with the keyframe loop unrolled at compile time;
//   C  cfear_radarodometry_code_public_tpu/ops/pallas_assoc.py:nn_min_sparse
//      (_nn_sparse_kernel): the same, skipping (256-row source tile, 512-row
//      target tile) pairs whose bounding boxes are farther apart than the
//      association radius;
//   D1 pallas_assoc.py:nn_min_sparse_multi (_nn_sparse_multi_kernel): C's
//      function with the keyframe loop inside the kernel, at runtime;
//   D2 pallas_assoc.py:nn_min_sparse_unrolled (_nn_sparse_unrolled_kernel):
//      C's function with the loops unrolled at compile time;
//   E  pallas_assoc.py:nn_min_sparse_attrs (_nn_sparse_attrs_kernel): C
//      plus the winning target's attribute column, looked up in the kernel.
//
// All take a leading lane axis, so one launch serves a whole batched step:
//   src (B, Msrc, 2) f32, tar (B, S, M, 2) f32, valid (B, S, M) u8
//   -> nn (B, S, Msrc) i32, d2 (B, S, Msrc) f32
// (E also attrs_t (B, S, D_pad, M) f32 -> g (B, S, D_pad, Msrc) f32).
//
// Contract (identical to the plain PyTorch twins in ops/cuda_assoc.py, bit
// for bit): d2 = (sx-tx)^2 + (sy-ty)^2 in the difference form, each
// operation rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn keep nvcc from
// contracting into an FMA, which would move d2 by an ulp and flip near-tie
// argmins); +inf for invalid targets; targets scanned in index order with a
// strict '<' so the lowest index wins ties, as argmin does; rows with no
// valid (or no unskipped) target report (+inf, 0). A, B1 and B2 share one
// per-pass scan (`scan_dense_pass`, `rescan_dense`), C's and E's first
// forms one per-tile scan (`scan_tile`), C's and E's split kernel (one
// template), D1 and D2 one per-slice scan (`scan_slice`), so each family
// gives the same bits.
//
// What bounds them on an H100: at the CFEAR-3 bench shape (B=8, S=4,
// M=Msrc=1024) one call is ~34 M distance evaluations, microseconds of ALU
// work spread over 128 (C's first form) blocks — fewer blocks than a full
// wave of 132 SMs x several resident blocks. The calls are bound by launch
// latency and by the short grid, not by bytes (~0.2 MB read) or FLOPs.
// The first forms of C and E (`nn_min_sparse_kernel`,
// `nn_min_sparse_attrs_kernel`, kept for keyframes of more than 32,768
// cells) have the simple design: one source row per thread, the
// keyframe's targets staged through shared memory in tiles so every thread
// reads the same target (a broadcast, no bank conflicts).
//
// C has a design of its own (`nn_min_sparse_split_kernel`). The contract
// fixes the arithmetic: five unfused operations a distance, so no FMA and
// no tensor core, and the FMA-rate bound of 67 TFLOP/s is out of reach;
// what bounds C is issue slots. The first form ran at ~18 of the card's
// issue slots a distance (three shared loads, the validity test, the
// compare and two selects, for one source row per thread) and tied its
// grid to B*S*Msrc/256 blocks. Now:
//  - 4 source rows a thread, so each staged target serves 4 distances;
//    targets staged as float2 with invalid ones at (+inf, +inf), so no
//    validity byte and no select, read as float4 (two targets) broadcasts;
//  - a row's minimum over a group of 16 targets is one FMNMX a distance;
//    its best moves to the group's minimum, remembering the group, only on
//    a strict '<'; at the end the winning group is scanned once more for
//    the first target at exactly that distance. The result is the lowest
//    index at the minimum, as a strict '<' scan in index order gives;
//  - each live 512-row tile is cut into 4 slices of 128 targets, one per
//    pair of warps, and a cluster of up to 8 CTAs (ops/cuda_assoc.py:
//    sparse_split, from the shape alone) cuts the keyframe's tiles, so the
//    grid grows past B*S*Msrc/256 where that is short; slices, then ranks
//    through distributed shared memory, are merged in a fixed order by
//    lexicographic (d2, index), which equals the scan over any partition;
//  - the bbox gap test and the live set are those of the first form: a
//    dead tile is neither staged nor scanned, a CTA with no live tile only
//    writes (+inf, 0).
// The inner loop is 5 FP operations, one FMNMX, 1/8 LDS.128 and 3/16 of a
// group update a distance: 6.39 SASS instructions. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (tools/compare_torch_kernels.py, CUDA events):
// 0.112 ms at B=8, S=50, M=1024 (0.208 for the first form), 67% of that
// issue floor, with 46 registers holding 5 CTAs an SM; 0.0147 ms at B=8,
// S=4 (0.039), where a call's fixed path (launch, the bounds then the
// tiles from memory, two barriers, the merge) outweighs the loop.
//
// A has C's design without the live set (`nn_min_dense_kernel`). Its
// first form (one source row per thread walking all M targets, a grid of
// B*S*ceil(Msrc/128) blocks of 128 threads: 64 blocks at the long run's
// B=1, S=4, 16 at the health check's S=1) ran at ~18 issue slots a
// distance and left most SMs idle at B=1. Now every target is staged and
// scanned, with no bounds: a keyframe's M targets are cut into chunks of
// 256, the last padded with (+inf, +inf) (a padded target never equals a
// finite best, so the rescan cannot land on it); a cluster of up to 8 CTAs
// (ops/cuda_assoc.py:dense_split, from the shape alone) shares a
// keyframe's chunks; a CTA stages its chunks 2,048 targets a pass, so any
// M runs, and rescans a row's winning group in the pass where its best
// moved; 4 source rows a thread over a 256-row source tile (rows past
// Msrc computed, not written), 4 slices of 64 targets a chunk, groups of
// 16 with one FMNMX a distance; slices, then ranks, merged by
// lexicographic (d2, index). A source row at +-inf or NaN reports (+inf,
// 0), as the first form and B1/B2 do: its distances are +inf or NaN, and
// neither becomes a best (the plain twin, and the reference, report NaN
// with an index for a NaN row instead; ROADMAP.md queue 3). B1 and B2
// report the same.
// Its loop is C's: 6.41 SASS instructions a distance, 47 registers, 26 KB
// of shared memory a CTA. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/compare_torch_kernels.py, CUDA events), first form -> this one:
// 0.0780 -> 0.0136 ms at the long run's B=1, S=4, M=2048 (a cluster of 8),
// 0.0768 -> 0.0085 at the health check's S=1, 0.0955 -> 0.0390 at B=8,
// 0.262 -> 0.120 at sample_covariance's B=27 (72% of the issue floor), and
// 0.0431 -> 0.0147 at B=8, S=4, M=1024 (a cluster of 2).
//
// B1 and B2 exist on the TPU for the same reason as D1 and D2 below: the
// grid runs in order on one core and every grid step has a fixed cost
// (~5 us), so the reference moved the keyframe axis of A's (S, Msrc/ts)
// grid into the kernel. Hopper has no such cost. Their first form kept the
// TPU's shape, one block per (lane, source tile of 512 rows), each thread
// one source row walking S keyframes of M targets with a validity select
// on every target: 32 blocks on 132 SMs at the long run's B=8, S=4,
// M=2048, ~18 issue slots a distance, 0.28 ms against A's 0.039. What a
// loop over keyframes can buy on Hopper is what D1/D2's walk takes, over
// A's dense scan (`nn_min_dense_walk_kernel`):
//  - the grid is (lane, keyframe group, rank) x source tile; a lane's S
//    keyframes are cut into G contiguous groups walked in index order (G as
//    D1/D2 pick it) and, where G = S still leaves the grid short, each
//    keyframe's chunks are shared by a cluster of C ranks as in A
//    (ops/cuda_assoc.py:multi_split; C > 1 only at G = S, so a cluster
//    merges once); at every shape of the smoke's G = S, one keyframe a CTA,
//    which its sweep found the fastest;
//  - the scan is A's (4 source rows a thread held in registers for the
//    whole walk, slices of 64 targets, groups of 16 with one FMNMX a
//    distance, the strict '<', the rescan of the winning group in the pass
//    where a row's best moved, slices and ranks merged by lexicographic
//    (d2, index)), so the outputs are A's bit for bit;
//  - a pass stages up to 2,048 of a keyframe's targets in one stage of a
//    two-stage ring; the next pass (the keyframe's next stage or the next
//    keyframe's first) is copied by cp.async, 16 bytes (two targets) at a
//    time with their 4 valid bytes, while the current one is scanned; a
//    thread then sets its own invalid and padding targets to (+inf, +inf),
//    so one barrier a pass.
// B2 differs from B1 only in what the compiler knows: S a template argument
// (the list `UNROLLED_S` in ops/cuda_assoc.py: 1, the reverse problem of
// the health check, and 4, CFEAR-3's window) and the keyframe loop
// unrolled; B2 at any other S launches the runtime-count instance, B1's,
// which gives the same bits. Their loop is A's, 410 SASS instructions,
// 6.41 a distance; B1 takes 64 registers, B2 at S=4 102 (the unrolled
// walk), and 46 KB of shared memory a CTA. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, CUDA events), first form -> this one, B1 / B2: 0.2798 /
// 0.2862 -> 0.0389 / 0.0376 ms at the long-run window's B=8, S=4, M=2048
// (A 0.0387), 0.0714 / 0.0753 -> 0.0150 / 0.0154 at its B=8, S=1 (A
// 0.0196, a cluster of 4 where the walk's rule takes 2); 0.77-1.12x A at
// the other shapes of chip_smoke.A_SHAPES.
//
// D1 and D2 exist on the TPU because every grid step there has a fixed
// cost (3,200 thin steps at B=8, S=50); a loop inside the kernel replaced
// the keyframe grid axis. Hopper has no such cost. Their first form kept
// the TPU's shape, one block of 256 threads per (lane, source tile), each
// thread one source row walking the S keyframes and staging each live tile
// by plain loads between two barriers: 32 blocks on 132 SMs at B=8, M=1024,
// the load latency never overlapped, ~18 issue slots a distance. What a
// loop over keyframes can buy on Hopper is what this design
// (`nn_min_sparse_walk_kernel`) takes: the source rows held in registers
// across keyframes, a CTA's fixed path (bounds, source rows) paid once for
// several keyframes, and the next keyframe's tiles copied while the
// current one is scanned. What bounds it is what bounds C, issue slots
// under the unfused contract, so its scan is C's (`scan_slice`, 4 source
// rows a thread, slices of 128 targets, groups of 16, one FMNMX a
// distance, the strict '<', the rescan, the lexicographic slice merge):
//  - the grid is (lane, keyframe group) x source tile; a lane's S
//    keyframes are cut into G contiguous groups walked in index order, G
//    from the shape alone (ops/cuda_assoc.py:walk_groups: the smallest G
//    up to S that gives 800 CTAs, about six an SM); each keyframe's output
//    is its own, so groups need no merge;
//  - each keyframe's live tiles come from the bbox gap test in scan_tile's
//    arithmetic, one tile a lane and a ballot (the list is uniform), and
//    go to consecutive slots of a two-stage ring in dynamic shared memory
//    by cp.async, 16 bytes (two targets) at a time with their 4 valid
//    bytes; while one stage is scanned the next keyframe's tiles arrive in
//    the other; a thread then sets the invalid targets of its own copies
//    to (+inf, +inf), since cp.async copies bytes as they are, so one
//    barrier a pass and one more a keyframe for the merge;
//  - a stage holds min(M / 512, SPLIT_MAX_TILES) tiles; a keyframe with
//    more live tiles is walked in several passes, a row's winning group
//    rescanned in the pass where its best moved, so D1 takes any M.
// D2 differs from D1 only in what the compiler knows: M a template
// argument (the budgets of `UNROLLED_M`) and the pass loop unrolled by 2,
// so each step's stage is a constant; D2 at any other M launches the
// runtime-count instance, D1's, which gives the same bits.
// Their loop is C's: 6.41 (D1) and 6.44 (D2) SASS instructions a distance,
// 77 and 64 registers. What decides their time is how many CTAs an SM
// holds and how evenly keyframes fall on SMs, not the walk: at B=8, S=50,
// M=1024 one CTA a keyframe (G = S, C's grid) was fastest, two a CTA within
// 2-5%, 7 a CTA (256 CTAs) 19% slower (tools/compare_torch_kernels.py
// --mode d-sweep). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, CUDA events), first form -> this one: 1.74 -> 0.117 ms
// on the s50 window at B=8 (C 0.113; 61% of the 0.072 ms issue floor),
// 0.022 at B=1 (C 0.023), 0.047 on the s50-preset window (C 0.057: the
// ballot and cp.async stage its few live tiles faster than C's loads).
//
// E exists on the TPU to fold the attribute gather into the kernel, where
// it cost a one-hot MXU product per executed tile pair. On Hopper the
// winner's attributes are D_pad loads after the scan, once a row's argmin
// is known; E's extra work over C is that column copy alone (D_pad x 4
// bytes read and written a row, the reads from a keyframe's attribute
// slice that L2 holds), and the scan sets its time. So E is C's split
// kernel (`nn_min_sparse_split_kernel<true>`, C is `<false>`): the same
// scan, live set, rescan and merges, hence C's (nn, d2) by construction,
// from C's cluster rule (ops/cuda_assoc.py:sparse_split), and then, in the
// thread that writes a row's final (nn, d2) (after the slice merge, or
// after the cluster merge before the last cluster barrier), the column
// copy (`copy_column`): 8 loads in flight through the read-only path, then
// 8 stores, neighbouring rows on neighbouring addresses; zeros on +inf
// rows. No attribute tile is staged in shared memory: at D_pad 16 six live
// tiles would take 192 KB and cut the CTAs an SM holds. It saves the
// separate gather's launch and its (B, S, Msrc, D) round trip through
// device memory. Its loop is C's: 409 SASS instructions, 6.39 a distance.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/compare_torch_kernels.py, CUDA events), the first form (one
// source row per thread, scan_tile, ~18 issue slots a distance) -> this
// one: 0.2111-0.2129 -> 0.1098-0.1101 ms at B=8, S=50, M=1024 (C
// 0.1116-0.1122 in the same call), 0.0465-0.0468 -> 0.0231-0.0232 at B=1;
// 0.98-1.07x C at every shape of chip_smoke.C_SHAPES.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

// Kernel C's split (`nn_min_sparse_split_kernel`), from ops/cuda_assoc.py
// (`SPLIT_SLICE`, `SPLIT_GROUP`, `SPLIT_MAX_TILES`; ops/_build.py passes
// them): the targets of a 512-row tile one slice of threads scans, the
// targets whose minimum is taken before a row's best is updated, and the
// target tiles one CTA stages in shared memory.
#if !defined(CFEAR_SPLIT_SLICE) || !defined(CFEAR_SPLIT_GROUP) || \
    !defined(CFEAR_SPLIT_MAX_TILES)
#error "build with -DCFEAR_SPLIT_SLICE, -DCFEAR_SPLIT_GROUP and -DCFEAR_SPLIT_MAX_TILES (ops/_build.py does)"
#endif

// The target tile counts (M / 512) kernel D2 is instantiated for, as a bit
// mask: bit n set instantiates n tiles. The one list is `UNROLLED_M` in
// ops/cuda_assoc.py; ops/_build.py passes it here (a mask, because nvcc
// splits option values at commas). CFEAR_UNROLLED_S_MASK is the same for
// the keyframe counts of kernel B2 (`UNROLLED_S`).
// Kernel A (`nn_min_dense_kernel`), from ops/cuda_assoc.py (`DENSE_TILE`,
// `DENSE_ROWS`, `DENSE_CHUNK`, `DENSE_SLICE`, `DENSE_GROUP`, `DENSE_STAGE`;
// ops/_build.py passes them): the source rows of a CTA and of a thread, the
// targets a cluster rank takes at a time, the targets of a chunk one slice
// of threads scans, the targets whose minimum is taken before a row's best
// is updated, and the targets a CTA stages in one pass.
#if !defined(CFEAR_DENSE_TILE) || !defined(CFEAR_DENSE_ROWS) ||   \
    !defined(CFEAR_DENSE_CHUNK) || !defined(CFEAR_DENSE_SLICE) || \
    !defined(CFEAR_DENSE_GROUP) || !defined(CFEAR_DENSE_STAGE)
#error "build with -DCFEAR_DENSE_TILE, _ROWS, _CHUNK, _SLICE, _GROUP and _STAGE (ops/_build.py does)"
#endif

#ifndef CFEAR_UNROLLED_MASK
#error "build with -DCFEAR_UNROLLED_MASK=<tile-count bits> (ops/_build.py does)"
#endif
#ifndef CFEAR_UNROLLED_S_MASK
#error "build with -DCFEAR_UNROLLED_S_MASK=<keyframe-count bits> (ops/_build.py does)"
#endif

namespace {

constexpr int kTileS = 256;      // source rows per block, kernels C/D1/D2/E
constexpr int kTileT = 512;      // target rows per skip-test granule

__device__ __forceinline__ float dist2(float sx, float sy, float tx, float ty) {
  const float dx = __fsub_rn(sx, tx);
  const float dy = __fsub_rn(sy, ty);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The block's source row and its tile's skip-test inputs (kernels C/D1/D2/E,
// block kTileS, one source row per thread; Msrc % kTileS == 0).
struct SrcTile {
  float sx, sy;                       // this thread's source point
  float xmin, xmax, ymin, ymax, r2;   // the tile's bbox and the radius^2
};

__device__ __forceinline__ SrcTile load_src_tile(
    const float* __restrict__ src, const float* __restrict__ src_bounds,
    const float* __restrict__ radius, int lane, int tile, int Msrc) {
  const int row = tile * kTileS + threadIdx.x;
  const float* sb = src_bounds + (static_cast<size_t>(lane) * (Msrc / kTileS) + tile) * 4;
  const float r = radius[lane];
  SrcTile st;
  st.sx = src[(static_cast<size_t>(lane) * Msrc + row) * 2];
  st.sy = src[(static_cast<size_t>(lane) * Msrc + row) * 2 + 1];
  st.xmin = sb[0];
  st.xmax = sb[1];
  st.ymin = sb[2];
  st.ymax = sb[3];
  st.r2 = __fmul_rn(r, r);
  return st;
}

struct TileBuf {
  float x[kTileT];
  float y[kTileT];
  unsigned char v[kTileT];
};

// One (source tile, target tile jt) pair of keyframe (t, v, tb): the bbox
// gap test, uniform across the block so a skip is a branch no thread
// diverges on; then the target tile staged through shared memory and
// scanned in index order into (best, barg). Every thread of the block must
// call it with the same jt.
__device__ __forceinline__ void scan_tile(const SrcTile& st,
                                          const float* __restrict__ t,
                                          const unsigned char* __restrict__ v,
                                          const float* __restrict__ tb, int jt,
                                          TileBuf& sh, float& best, int& barg) {
  const float* b = tb + jt * 4;
  const float gapx = fmaxf(fmaxf(__fsub_rn(b[0], st.xmax), __fsub_rn(st.xmin, b[1])), 0.f);
  const float gapy = fmaxf(fmaxf(__fsub_rn(b[2], st.ymax), __fsub_rn(st.ymin, b[3])), 0.f);
  if (!(__fadd_rn(__fmul_rn(gapx, gapx), __fmul_rn(gapy, gapy)) <= st.r2)) return;
  const int base = jt * kTileT;
  __syncthreads();
  for (int k = threadIdx.x; k < kTileT; k += kTileS) {
    sh.x[k] = t[2 * (base + k)];
    sh.y[k] = t[2 * (base + k) + 1];
    sh.v[k] = v[base + k];
  }
  __syncthreads();
  for (int k = 0; k < kTileT; ++k) {
    const float d = sh.v[k] ? dist2(st.sx, st.sy, sh.x[k], sh.y[k]) : CUDART_INF_F;
    if (d < best) {
      best = d;
      barg = base + k;
    }
  }
}

// Pointers of keyframe bs = lane * S + s.
struct Keyframe {
  const float* t;
  const unsigned char* v;
  const float* tb;
};

__device__ __forceinline__ Keyframe keyframe(const float* tar,
                                             const unsigned char* valid,
                                             const float* tar_bounds, int bs,
                                             int M) {
  return {tar + static_cast<size_t>(bs) * M * 2,
          valid + static_cast<size_t>(bs) * M,
          tar_bounds + static_cast<size_t>(bs) * (M / kTileT) * 4};
}

// Kernel C's first form, one block per (keyframe, source tile) walking
// every target tile (`split` 0: kept for the shapes
// ops/cuda_assoc.py:sparse_split gives it). grid (B*S, Msrc / kTileS),
// block kTileS. src_bounds
// (B, Msrc/kTileS, 4), tar_bounds (B, S, M/kTileT, 4) as
// [xmin, xmax, ymin, ymax] (empty tiles +inf/-inf, so they never pass);
// radius (B,).
__global__ void nn_min_sparse_kernel(const float* __restrict__ src,
                                     const float* __restrict__ src_bounds,
                                     const float* __restrict__ tar,
                                     const float* __restrict__ tar_bounds,
                                     const unsigned char* __restrict__ valid,
                                     const float* __restrict__ radius,
                                     int S, int Msrc, int M,
                                     int* __restrict__ nn,
                                     float* __restrict__ d2) {
  __shared__ TileBuf sh;
  const int bs = blockIdx.x;
  const SrcTile st = load_src_tile(src, src_bounds, radius, bs / S, blockIdx.y, Msrc);
  const Keyframe kf = keyframe(tar, valid, tar_bounds, bs, M);
  float best = CUDART_INF_F;
  int barg = 0;
  for (int jt = 0; jt < M / kTileT; ++jt) scan_tile(st, kf.t, kf.v, kf.tb, jt, sh, best, barg);
  const size_t o = static_cast<size_t>(bs) * Msrc + blockIdx.y * kTileS + threadIdx.x;
  nn[o] = barg;
  d2[o] = best;
}

// Kernel C, split. One CTA of kThreadsC threads per (lane * S + keyframe,
// 256-row source tile, rank), a thread-block cluster of `C` ranks per
// (keyframe, source tile); rank c takes target tiles [c * nt / C,
// (c + 1) * nt / C) of the keyframe's nt = M / 512. Thread (slice q, l)
// holds source rows l + 64 j (j < kRowsC) and scans targets [q * 128, q *
// 128 + 128) of every live tile of its rank.
constexpr int kRowsC = 4;                            // source rows per thread
constexpr int kSliceC = CFEAR_SPLIT_SLICE;           // targets of a tile per slice
constexpr int kGroupC = CFEAR_SPLIT_GROUP;           // targets per minimum group
constexpr int kMaxTilesC = CFEAR_SPLIT_MAX_TILES;    // target tiles a CTA stages
constexpr int kSlicesC = kTileT / kSliceC;
constexpr int kRowThreadsC = kTileS / kRowsC;        // threads over a source tile
constexpr int kThreadsC = kRowThreadsC * kSlicesC;
static_assert(kTileT % kSliceC == 0 && kSliceC % kGroupC == 0 &&
              kGroupC % 2 == 0 && kRowThreadsC % 32 == 0 &&
              kThreadsC >= kTileS && kThreadsC <= 1024,
              "kernel C's split does not tile its block");

// (d, i) = the lexicographic minimum of (d, i) and (e, j): the smaller d,
// the lower index on a tie. Every partial with no finite distance is
// (+inf, 0), so a row with none anywhere stays (+inf, 0).
__device__ __forceinline__ void lex_min(float& d, int& i, float e, int j) {
  if (e < d || (e == d && j < i)) {
    d = e;
    i = j;
  }
}

// The scan of kernels C, D1 and D2 over one slice of kSliceC staged
// targets at p (two a float4), whose first lies at staged offset `base`.
// Each group of kGroupC targets: the minimum distance of each row by fminf
// alone (one FMNMX a distance, no index); the row's best moves, with the
// group's offset, only on a strict '<', so bg is the first group, in index
// order, that attains the row's best so far.
__device__ __forceinline__ void scan_slice(const float4* __restrict__ p, int base,
                                           const float (&sx)[kRowsC],
                                           const float (&sy)[kRowsC],
                                           float (&bv)[kRowsC], int (&bg)[kRowsC]) {
#pragma unroll 1
  for (int g = 0; g < kSliceC / kGroupC; ++g) {
    float gm[kRowsC];
#pragma unroll
    for (int j = 0; j < kRowsC; ++j) gm[j] = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < kGroupC / 2; ++k) {
      const float4 t = p[g * (kGroupC / 2) + k];
#pragma unroll
      for (int j = 0; j < kRowsC; ++j)
        gm[j] = fminf(gm[j], fminf(dist2(sx[j], sy[j], t.x, t.y),
                                   dist2(sx[j], sy[j], t.z, t.w)));
    }
#pragma unroll
    for (int j = 0; j < kRowsC; ++j) {
      if (gm[j] < bv[j]) {
        bv[j] = gm[j];
        bg[j] = base + g * kGroupC;
      }
    }
  }
}

// The offset within the winning group of staged targets w of the first
// whose distance, in the same rounded arithmetic, equals the row's best d.
__device__ __forceinline__ int first_at(const float2* __restrict__ w, float sx,
                                        float sy, float d) {
  int k = 0;
  while (k < kGroupC - 1 && dist2(sx, sy, w[k].x, w[k].y) != d) ++k;
  return k;
}

// Kernel E's epilogue: row `row` of source tile `tile` of keyframe bs,
// whose final (i, d) the caller has just written, gets its winner's
// attribute column, g[bs, :, tile * kTileS + row] = attrs_t[bs, :, i], or
// zeros where d = +inf. D_pad (a multiple of 8) loads through the
// read-only path, 8 in flight before their stores; neighbouring rows store
// to neighbouring addresses.
__device__ __forceinline__ void copy_column(const float* __restrict__ attrs_t,
                                            float* __restrict__ g, int bs,
                                            int tile, int row, int Msrc, int M,
                                            int Dpad, int i, float d) {
  const bool hit = d < CUDART_INF_F;
  const float* a = attrs_t + static_cast<size_t>(bs) * Dpad * M + i;
  float* o = g + static_cast<size_t>(bs) * Dpad * Msrc + tile * kTileS + row;
  for (int k0 = 0; k0 < Dpad; k0 += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = hit ? __ldg(a + static_cast<size_t>(k0 + k) * M) : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) o[static_cast<size_t>(k0 + k) * Msrc] = v[k];
  }
}

// Kernel C is kAttrs = false (attrs_t, Dpad and g unused); kernel E is
// kAttrs = true: the same scan, live set, rescan and merges, so its (nn,
// d2) are C's, and then `copy_column` by whichever thread writes a row.
template <bool kAttrs>
__global__ void __launch_bounds__(kThreadsC) nn_min_sparse_split_kernel(
    const float* __restrict__ src, const float* __restrict__ src_bounds,
    const float* __restrict__ tar, const float* __restrict__ tar_bounds,
    const unsigned char* __restrict__ valid, const float* __restrict__ radius,
    int S, int Msrc, int M, int C, int* __restrict__ nn,
    float* __restrict__ d2, const float* __restrict__ attrs_t, int Dpad,
    float* __restrict__ g) {
  // the rank's live target tiles, two targets a float4, invalid targets as
  // (+inf, +inf): dist2 of a finite source to one is +inf, of a source at
  // +-inf or NaN NaN; neither passes a '<' against a best that starts at
  // +inf, as the +inf of the other kernels' validity test does not
  extern __shared__ float4 stage[];
  __shared__ float part_d[kSlicesC][kTileS];
  __shared__ int part_i[kSlicesC][kTileS];
  __shared__ float res_d[kTileS];
  __shared__ int res_i[kTileS];
  const int bs = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int lane = bs / S;
  const int tile = blockIdx.y;
  const int nt = M / kTileT;
  const int t0 = rank * nt / C;
  const int n_loc = (rank + 1) * nt / C - t0;

  // the bbox gap test of scan_tile, in the same arithmetic, for each tile
  const float* sb = src_bounds + (static_cast<size_t>(lane) * (Msrc / kTileS) + tile) * 4;
  const float* tb = tar_bounds + (static_cast<size_t>(bs) * nt + t0) * 4;
  const float r = radius[lane];
  const float r2 = __fmul_rn(r, r);
  unsigned live = 0;
  for (int jt = 0; jt < n_loc; ++jt) {
    const float* b = tb + jt * 4;
    const float gapx = fmaxf(fmaxf(__fsub_rn(b[0], sb[1]), __fsub_rn(sb[0], b[1])), 0.f);
    const float gapy = fmaxf(fmaxf(__fsub_rn(b[2], sb[3]), __fsub_rn(sb[2], b[3])), 0.f);
    if (__fadd_rn(__fmul_rn(gapx, gapx), __fmul_rn(gapy, gapy)) <= r2) live |= 1u << jt;
  }

  const int q = threadIdx.x / kRowThreadsC;
  const int l = threadIdx.x % kRowThreadsC;
  float bv[kRowsC];
  int bi[kRowsC];
#pragma unroll
  for (int j = 0; j < kRowsC; ++j) {
    bv[j] = CUDART_INF_F;
    bi[j] = 0;
  }
  if (live) {   // uniform over the CTA
    const float2* t2 = reinterpret_cast<const float2*>(tar) + static_cast<size_t>(bs) * M;
    const unsigned char* v = valid + static_cast<size_t>(bs) * M;
    float2* st2 = reinterpret_cast<float2*>(stage);
    for (int jt = 0; jt < n_loc; ++jt) {
      if (!((live >> jt) & 1u)) continue;
      const int g0 = (t0 + jt) * kTileT;
      for (int k = threadIdx.x; k < kTileT; k += kThreadsC)
        st2[jt * kTileT + k] = v[g0 + k] ? t2[g0 + k]
                                         : make_float2(CUDART_INF_F, CUDART_INF_F);
    }
    const float2* s2 = reinterpret_cast<const float2*>(src) +
                       static_cast<size_t>(lane) * Msrc + tile * kTileS + l;
    float sx[kRowsC], sy[kRowsC];
    int bg[kRowsC];
#pragma unroll
    for (int j = 0; j < kRowsC; ++j) {
      const float2 p = s2[j * kRowThreadsC];
      sx[j] = p.x;
      sy[j] = p.y;
      bg[j] = 0;
    }
    __syncthreads();
    for (int jt = 0; jt < n_loc; ++jt) {
      if (!((live >> jt) & 1u)) continue;
      const int base = jt * kTileT + q * kSliceC;
      scan_slice(stage + base / 2, base, sx, sy, bv, bg);
    }
    // the lowest index of the winning group at the best: the slice's first
    // minimum
#pragma unroll
    for (int j = 0; j < kRowsC; ++j)
      if (bv[j] < CUDART_INF_F)
        bi[j] = t0 * kTileT + bg[j] + first_at(st2 + bg[j], sx[j], sy[j], bv[j]);
  }
#pragma unroll
  for (int j = 0; j < kRowsC; ++j) {
    part_d[q][l + j * kRowThreadsC] = bv[j];
    part_i[q][l + j * kRowThreadsC] = bi[j];
  }
  __syncthreads();
  // slices, then ranks, merged in a fixed order by lexicographic minimum
  const size_t out0 = static_cast<size_t>(bs) * Msrc + tile * kTileS;
  if (threadIdx.x < kTileS) {
    const int row = threadIdx.x;
    float d = part_d[0][row];
    int i = part_i[0][row];
#pragma unroll
    for (int s = 1; s < kSlicesC; ++s) lex_min(d, i, part_d[s][row], part_i[s][row]);
    if (C == 1) {
      nn[out0 + row] = i;
      d2[out0 + row] = d;
      if constexpr (kAttrs) copy_column(attrs_t, g, bs, tile, row, Msrc, M, Dpad, i, d);
    } else {
      res_d[row] = d;
      res_i[row] = i;
    }
  }
  if (C > 1) {   // uniform over the cluster
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int per = kTileS / C;
    if (threadIdx.x < per) {
      const int row = rank * per + threadIdx.x;
      float d = cluster.map_shared_rank(res_d, 0)[row];
      int i = cluster.map_shared_rank(res_i, 0)[row];
      for (int c = 1; c < C; ++c)
        lex_min(d, i, cluster.map_shared_rank(res_d, c)[row],
                cluster.map_shared_rank(res_i, c)[row]);
      nn[out0 + row] = i;
      d2[out0 + row] = d;
      if constexpr (kAttrs) copy_column(attrs_t, g, bs, tile, row, Msrc, M, Dpad, i, d);
    }
    cluster.sync();   // no CTA leaves while a peer reads its shared memory
  }
}

// Kernel A. One CTA of kDenseThreads threads per (lane * S + keyframe,
// kDenseTile-row source tile, rank), a thread-block cluster of `C` ranks per
// (keyframe, source tile); the keyframe's targets are cut into nc =
// ceil(M / kDenseChunk) chunks, the last padded with (+inf, +inf), and rank
// c takes chunks [c * nc / C, (c + 1) * nc / C), staged kDenseStage targets
// a pass. Thread (slice q, l) holds source rows l + kDenseRowThreads * j (j <
// kDenseRows; rows past Msrc are computed and not written) and scans targets
// [q * kDenseSlice, (q + 1) * kDenseSlice) of every chunk of its rank.
constexpr int kDenseTile = CFEAR_DENSE_TILE;     // source rows a CTA
constexpr int kDenseRows = CFEAR_DENSE_ROWS;     // source rows a thread
constexpr int kDenseChunk = CFEAR_DENSE_CHUNK;   // targets a rank takes at a time
constexpr int kDenseSlice = CFEAR_DENSE_SLICE;   // targets of a chunk per slice
constexpr int kDenseGroup = CFEAR_DENSE_GROUP;   // targets per minimum group
constexpr int kDenseStage = CFEAR_DENSE_STAGE;   // targets staged per pass
constexpr int kDenseSlices = kDenseChunk / kDenseSlice;
constexpr int kDenseRowThreads = kDenseTile / kDenseRows;
constexpr int kDenseThreads = kDenseRowThreads * kDenseSlices;
static_assert(kDenseTile % kDenseRows == 0 && kDenseChunk % kDenseSlice == 0 &&
              kDenseSlice % kDenseGroup == 0 && kDenseGroup % 2 == 0 &&
              kDenseStage % kDenseChunk == 0 && kDenseRowThreads % 32 == 0 &&
              kDenseThreads >= kDenseTile && kDenseThreads <= 1024 &&
              kDenseRows <= 32,
              "kernel A does not tile its block");

// Kernel A's scan of one staged pass, shared with B1 and B2: n targets
// (whole chunks) of a keyframe from its target `base`, two a float4 at
// `stage`, of which thread slice q takes targets [q * kDenseSlice, (q + 1)
// * kDenseSlice) of each chunk. Each group of kDenseGroup targets: the
// minimum distance of each row by fminf alone (one FMNMX a distance, no
// index); the row's best moves, with the group's first index, only on a
// strict '<', so bg is the first group, in index order, that attains the
// row's best so far.
__device__ __forceinline__ void scan_dense_pass(
    const float4* __restrict__ stage, int base, int n, int q,
    const float (&sx)[kDenseRows], const float (&sy)[kDenseRows],
    float (&bv)[kDenseRows], int (&bg)[kDenseRows]) {
  for (int c = 0; c < n / kDenseChunk; ++c) {
    const int off = c * kDenseChunk + q * kDenseSlice;
    const float4* p = stage + off / 2;
#pragma unroll 1
    for (int g = 0; g < kDenseSlice / kDenseGroup; ++g) {
      float gm[kDenseRows];
#pragma unroll
      for (int j = 0; j < kDenseRows; ++j) gm[j] = CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < kDenseGroup / 2; ++k) {
        const float4 t = p[g * (kDenseGroup / 2) + k];
#pragma unroll
        for (int j = 0; j < kDenseRows; ++j)
          gm[j] = fminf(gm[j], fminf(dist2(sx[j], sy[j], t.x, t.y),
                                     dist2(sx[j], sy[j], t.z, t.w)));
      }
#pragma unroll
      for (int j = 0; j < kDenseRows; ++j) {
        if (gm[j] < bv[j]) {
          bv[j] = gm[j];
          bg[j] = base + off + g * kDenseGroup;
        }
      }
    }
  }
}

// After scan_dense_pass over the pass staged (two targets a float4) at st2
// from keyframe target `base`: a row whose best moved in this pass (its
// group lies in the pass) gets the lowest index of the winning group whose
// distance, in the same rounded arithmetic, equals the best.
__device__ __forceinline__ void rescan_dense(
    const float2* __restrict__ st2, int base, const float (&sx)[kDenseRows],
    const float (&sy)[kDenseRows], const float (&bv)[kDenseRows],
    const int (&bg)[kDenseRows], int (&bi)[kDenseRows]) {
#pragma unroll
  for (int j = 0; j < kDenseRows; ++j) {
    if (bg[j] >= base) {
      const float2* w = st2 + (bg[j] - base);
      int k = 0;
      while (k < kDenseGroup - 1 && dist2(sx[j], sy[j], w[k].x, w[k].y) != bv[j])
        ++k;
      bi[j] = bg[j] + k;
    }
  }
}

// The end of a keyframe in kernels A, B1 and B2: thread (q, l)'s rows'
// (bv, bi) merged over the slices, then over the C ranks of the cluster
// through distributed shared memory, in a fixed order by lexicographic
// minimum, and written at out0 (the `rows` of the tile that lie in Msrc).
// With C > 1 it syncs the cluster: every CTA of it must call it once.
__device__ __forceinline__ void merge_dense(
    float (&part_d)[kDenseSlices][kDenseTile],
    int (&part_i)[kDenseSlices][kDenseTile], float (&res_d)[kDenseTile],
    int (&res_i)[kDenseTile], int q, int l, const float (&bv)[kDenseRows],
    const int (&bi)[kDenseRows], int C, int rank, size_t out0, int rows,
    int* __restrict__ nn, float* __restrict__ d2) {
#pragma unroll
  for (int j = 0; j < kDenseRows; ++j) {
    part_d[q][l + j * kDenseRowThreads] = bv[j];
    part_i[q][l + j * kDenseRowThreads] = bi[j];
  }
  __syncthreads();
  if (threadIdx.x < kDenseTile) {
    const int row = threadIdx.x;
    float d = part_d[0][row];
    int i = part_i[0][row];
#pragma unroll
    for (int s = 1; s < kDenseSlices; ++s) lex_min(d, i, part_d[s][row], part_i[s][row]);
    if (C > 1) {
      res_d[row] = d;
      res_i[row] = i;
    } else if (row < rows) {
      nn[out0 + row] = i;
      d2[out0 + row] = d;
    }
  }
  if (C > 1) {   // uniform over the cluster
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int per = kDenseTile / C;
    const int row = rank * per + threadIdx.x;
    if (threadIdx.x < per && row < rows) {
      float d = cluster.map_shared_rank(res_d, 0)[row];
      int i = cluster.map_shared_rank(res_i, 0)[row];
      for (int c = 1; c < C; ++c)
        lex_min(d, i, cluster.map_shared_rank(res_d, c)[row],
                cluster.map_shared_rank(res_i, c)[row]);
      nn[out0 + row] = i;
      d2[out0 + row] = d;
    }
    cluster.sync();   // no CTA leaves while a peer reads its shared memory
  }
}

__global__ void __launch_bounds__(kDenseThreads) nn_min_dense_kernel(
    const float* __restrict__ src, const float* __restrict__ tar,
    const unsigned char* __restrict__ valid, int S, int Msrc, int M, int C,
    int* __restrict__ nn, float* __restrict__ d2) {
  // one pass of the rank's targets, two a float4, invalid and padding
  // targets as (+inf, +inf): dist2 of a finite source to one is +inf, of a
  // source at +-inf or NaN NaN; fminf drops a NaN, so neither ever becomes
  // a best, which starts at +inf. A source row at +-inf or NaN thus reports
  // (+inf, 0).
  __shared__ float4 stage[kDenseStage / 2];
  __shared__ float part_d[kDenseSlices][kDenseTile];
  __shared__ int part_i[kDenseSlices][kDenseTile];
  __shared__ float res_d[kDenseTile];
  __shared__ int res_i[kDenseTile];
  const int bs = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int lane = bs / S;
  const int tile = blockIdx.y;
  const int nc = (M + kDenseChunk - 1) / kDenseChunk;
  const int lo = rank * nc / C * kDenseChunk;
  const int hi = (rank + 1) * nc / C * kDenseChunk;
  const int q = threadIdx.x / kDenseRowThreads;
  const int l = threadIdx.x % kDenseRowThreads;
  const float2 inf2 = make_float2(CUDART_INF_F, CUDART_INF_F);
  const float2* s2 = reinterpret_cast<const float2*>(src) + static_cast<size_t>(lane) * Msrc;
  const float2* t2 = reinterpret_cast<const float2*>(tar) + static_cast<size_t>(bs) * M;
  const unsigned char* v = valid + static_cast<size_t>(bs) * M;
  float2* st2 = reinterpret_cast<float2*>(stage);
  float sx[kDenseRows], sy[kDenseRows], bv[kDenseRows];
  int bg[kDenseRows], bi[kDenseRows];
#pragma unroll
  for (int j = 0; j < kDenseRows; ++j) {
    const int row = tile * kDenseTile + l + j * kDenseRowThreads;
    const float2 p = row < Msrc ? s2[row] : make_float2(0.f, 0.f);
    sx[j] = p.x;
    sy[j] = p.y;
    bv[j] = CUDART_INF_F;
    bg[j] = -1;
    bi[j] = 0;
  }
  for (int base = lo; base < hi; base += kDenseStage) {
    const int n = min(kDenseStage, hi - base);   // whole chunks
    if (base != lo) __syncthreads();   // the last pass's rescans have read it
#pragma unroll 4
    for (int k = threadIdx.x; k < n; k += kDenseThreads) {
      const int g = base + k;
      const bool in = g < M;
      const float2 t = in ? t2[g] : inf2;
      st2[k] = in && v[g] ? t : inf2;
    }
    __syncthreads();
    scan_dense_pass(stage, base, n, q, sx, sy, bv, bg);
    rescan_dense(st2, base, sx, sy, bv, bg, bi);
  }
  merge_dense(part_d, part_i, res_d, res_i, q, l, bv, bi, C, rank,
              static_cast<size_t>(bs) * Msrc + tile * kDenseTile,
              min(kDenseTile, Msrc - tile * kDenseTile), nn, d2);
}

// Kernels D1 and D2. One CTA of kThreadsC threads per (lane * G + group,
// 256-row source tile): group g of the G takes the lane's keyframes [g * S /
// G, (g + 1) * S / G) in index order. Thread (slice q, l) holds source rows
// l + 64 j (j < kRowsC) in registers for the whole walk and scans targets
// [q * 128, q * 128 + 128) of every live tile, as in kernel C. The walk is
// a sequence of passes, each the live tiles of one keyframe, at most `cap`
// = min(M / 512, kMaxTilesC) of them (one pass a keyframe unless a
// keyframe has more live tiles than that); a two-stage ring in dynamic
// shared memory takes the next pass's tiles by cp.async while the current
// one is scanned. D1 is kNT = 0: M is read at runtime. D2 is kNT > 0: M =
// kNT * kTileT is known at compile time, and the pass loop is unrolled by 2
// so each step's stage is a constant.
constexpr int kChunkW = 4;                        // targets a copy chunk
constexpr int kChunksT = kTileT / kChunkW;        // copy chunks of a tile
constexpr int kCopyWays = kThreadsC / kChunksT;   // tiles copied side by side
static_assert(kThreadsC % kChunksT == 0 && kChunkW == 4,
              "kernels D1/D2 copy a tile in 16-byte pieces, 4 valid bytes a thread");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

// One pass of the walk: keyframe s (of the lane), n tiles staged (-1: the
// walk is over), and whether it is the first and the last of s's passes.
struct Pass {
  int s, n;
  bool first, last;
};

template <int kNT>
__global__ void __launch_bounds__(kThreadsC) nn_min_sparse_walk_kernel(
    const float* __restrict__ src, const float* __restrict__ src_bounds,
    const float* __restrict__ tar, const float* __restrict__ tar_bounds,
    const unsigned char* __restrict__ valid, const float* __restrict__ radius,
    int S, int Msrc, int M, int G, int* __restrict__ nn,
    float* __restrict__ d2) {
  // the ring: [2][cap * kTileT] float2 targets, then [2][cap * kTileT]
  // valid bytes, which arrive as copied; a pass's own copier then sets its
  // invalid targets to (+inf, +inf), as kernel C stages them
  extern __shared__ float4 stage[];
  __shared__ float part_d[kSlicesC][kTileS];
  __shared__ int part_i[kSlicesC][kTileS];
  __shared__ int slot_tile[2][kMaxTilesC];   // the target tile in each slot
  const int m = kNT > 0 ? kNT * kTileT : M;
  const int nt = m / kTileT;
  const int cap = min(nt, kMaxTilesC);
  const int lane = blockIdx.x / G;
  const int grp = blockIdx.x % G;
  const int tile = blockIdx.y;
  const int s_end = (grp + 1) * S / G;
  float2* const ring = reinterpret_cast<float2*>(stage);
  unsigned char* const vring = reinterpret_cast<unsigned char*>(ring + 2 * cap * kTileT);

  // the source tile's bbox and r^2, for the gap test of scan_tile
  const float* sb = src_bounds + (static_cast<size_t>(lane) * (Msrc / kTileS) + tile) * 4;
  const float sxmin = sb[0], sxmax = sb[1], symin = sb[2], symax = sb[3];
  const float r = radius[lane];
  const float r2 = __fmul_rn(r, r);

  // the producer: the next keyframe and target tile to test. Each live
  // tile (a lane of every warp tests one of 32 tiles, then a ballot: the
  // list is uniform over the CTA) goes to the next slot, copied 4 targets
  // and their 4 valid bytes a thread by the threads of its way
  int s_p = grp * S / G, j_p = 0;
  const int c = threadIdx.x % kChunksT;
  const int way = threadIdx.x / kChunksT;
  const float2* t2 = reinterpret_cast<const float2*>(tar);
  auto fill = [&](int k) {
    Pass p{s_p, 0, j_p == 0, true};
    if (s_p >= s_end) {
      p.n = -1;
      return p;
    }
    const size_t bs = static_cast<size_t>(lane) * S + s_p;
    const float* tb = tar_bounds + bs * nt * 4;
    float2* st = ring + k * cap * kTileT;
    unsigned char* vst = vring + k * cap * kTileT;
    while (p.n < cap && j_p < nt) {
      const int jt = j_p + static_cast<int>(threadIdx.x % 32);
      bool live = false;
      if (jt < nt) {
        const float* b = tb + jt * 4;
        const float gapx = fmaxf(fmaxf(__fsub_rn(b[0], sxmax), __fsub_rn(sxmin, b[1])), 0.f);
        const float gapy = fmaxf(fmaxf(__fsub_rn(b[2], symax), __fsub_rn(symin, b[3])), 0.f);
        live = __fadd_rn(__fmul_rn(gapx, gapx), __fmul_rn(gapy, gapy)) <= r2;
      }
      unsigned w = __ballot_sync(0xffffffffu, live);
      int taken = j_p - 1;
      while (w && p.n < cap) {
        taken = j_p + __ffs(w) - 1;
        w &= w - 1;
        if (p.n % kCopyWays == way) {
          const int o = p.n * kTileT + c * kChunkW;
          const size_t g = bs * m + taken * kTileT + c * kChunkW;
          cp_async16(st + o, t2 + g);
          cp_async16(st + o + 2, t2 + g + 2);
          cp_async4(vst + o, valid + g);
        }
        if (threadIdx.x == 0) slot_tile[k][p.n] = taken;
        ++p.n;
      }
      j_p = w ? taken + 1 : min(j_p + 32, nt);
    }
    p.last = j_p >= nt;
    if (p.last) {
      ++s_p;
      j_p = 0;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return p;
  };

  const int q = threadIdx.x / kRowThreadsC;
  const int l = threadIdx.x % kRowThreadsC;
  const float2* s2 = reinterpret_cast<const float2*>(src) +
                     static_cast<size_t>(lane) * Msrc + tile * kTileS + l;
  float sx[kRowsC], sy[kRowsC], bv[kRowsC];
  int bi[kRowsC], bg[kRowsC];
#pragma unroll
  for (int j = 0; j < kRowsC; ++j) {
    const float2 p = s2[j * kRowThreadsC];
    sx[j] = p.x;
    sy[j] = p.y;
  }

  // Pass `cur` in stage k: wait for this thread's copies and fix its own
  // chunks' invalid targets; one barrier; start the next pass's copies into
  // the other stage; scan (C's loop), rescan the rows whose best moved in
  // this pass; after a keyframe's last pass merge the slices and write.
  Pass cur = fill(0);
  auto step = [&](int k) {
    if (cur.n < 0) return false;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    float2* st = ring + k * cap * kTileT;
    const unsigned char* vst = vring + k * cap * kTileT;
    for (int i = way; i < cur.n; i += kCopyWays) {
      const int o = i * kTileT + c * kChunkW;
      const unsigned v4 = *reinterpret_cast<const unsigned*>(vst + o);
#pragma unroll
      for (int b = 0; b < kChunkW; ++b)
        if (!((v4 >> (8 * b)) & 0xffu)) st[o + b] = make_float2(CUDART_INF_F, CUDART_INF_F);
    }
    __syncthreads();
    const Pass next = fill(k ^ 1);
#pragma unroll
    for (int j = 0; j < kRowsC; ++j) {
      if (cur.first) {
        bv[j] = CUDART_INF_F;
        bi[j] = 0;
      }
      bg[j] = -1;
    }
    for (int i = 0; i < cur.n; ++i) {
      const int base = i * kTileT + q * kSliceC;
      scan_slice(stage + (k * cap * kTileT + base) / 2, base, sx, sy, bv, bg);
    }
#pragma unroll
    for (int j = 0; j < kRowsC; ++j)
      if (bg[j] >= 0)
        bi[j] = slot_tile[k][bg[j] / kTileT] * kTileT + bg[j] % kTileT +
                first_at(st + bg[j], sx[j], sy[j], bv[j]);
    if (cur.last) {   // uniform over the CTA
#pragma unroll
      for (int j = 0; j < kRowsC; ++j) {
        part_d[q][l + j * kRowThreadsC] = bv[j];
        part_i[q][l + j * kRowThreadsC] = bi[j];
      }
      __syncthreads();
      if (threadIdx.x < kTileS) {
        const int row = threadIdx.x;
        float d = part_d[0][row];
        int i = part_i[0][row];
#pragma unroll
        for (int s = 1; s < kSlicesC; ++s) lex_min(d, i, part_d[s][row], part_i[s][row]);
        const size_t o = (static_cast<size_t>(lane) * S + cur.s) * Msrc + tile * kTileS + row;
        nn[o] = i;
        d2[o] = d;
      }
    }
    cur = next;
    return true;
  };
  if constexpr (kNT > 0) {
    while (step(0) && step(1)) {
    }
  } else {
    for (int k = 0; step(k); k ^= 1) {
    }
  }
}

// Kernels B1 and B2. One CTA of kDenseThreads threads per (lane * G +
// group, kDenseTile-row source tile, rank), a thread-block cluster of C
// ranks per (lane, group, source tile), C > 1 only where G = S (one
// keyframe a CTA, so a cluster merges once): group g of the G takes the
// lane's keyframes [g * S / G, (g + 1) * S / G) in index order, and rank c
// each keyframe's chunks [c * nc / C, (c + 1) * nc / C) of nc = ceil(M /
// kDenseChunk), the last padded with (+inf, +inf), as kernel A does. Thread
// (slice q, l) holds source rows l + kDenseRowThreads * j (j < kDenseRows;
// rows past Msrc computed, not written) in registers for the whole walk.
// The walk is a sequence of passes, each up to kDenseStage of a keyframe's
// targets; a two-stage ring takes the next pass by cp.async while the
// current one is scanned with A's scan. B1 is kS = 0 (S read at runtime),
// B2 kS > 0 (S = kS known at compile time, the keyframe loop unrolled).
// tar 16-byte and valid 4-byte aligned (the wrapper checks). Where M % 4
// != 0 a lane's rows are not 16-byte aligned, and each thread loads its
// units element by element instead of by cp.async (the same staged
// values, without the overlap).
constexpr int kCopyUnit = 4;   // targets a thread copies at a time
static_assert(kDenseChunk % kCopyUnit == 0,
              "kernels B1/B2 copy whole units of 4 targets a chunk");

template <int kS>
__global__ void __launch_bounds__(kDenseThreads) nn_min_dense_walk_kernel(
    const float* __restrict__ src, const float* __restrict__ tar,
    const unsigned char* __restrict__ valid, int S, int Msrc, int M, int G,
    int C, int* __restrict__ nn, float* __restrict__ d2) {
  // the ring: two stages of kDenseStage targets, two a float4, and their
  // valid bytes, which arrive as copied; each copier then sets its own
  // invalid and padding targets to (+inf, +inf), as kernel A stages them
  __shared__ float4 ring[2][kDenseStage / 2];
  __shared__ unsigned vring[2][kDenseStage / kCopyUnit];
  __shared__ float part_d[kDenseSlices][kDenseTile];
  __shared__ int part_i[kDenseSlices][kDenseTile];
  __shared__ float res_d[kDenseTile];
  __shared__ int res_i[kDenseTile];
  const int s_n = kS > 0 ? kS : S;
  const int lg = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int lane = lg / G;
  const int grp = lg % G;
  const int tile = blockIdx.y;
  const int s0 = grp * s_n / G;
  const int s_end = (grp + 1) * s_n / G;
  const int nc = (M + kDenseChunk - 1) / kDenseChunk;
  const int lo = rank * nc / C * kDenseChunk;
  const int hi = (rank + 1) * nc / C * kDenseChunk;
  // a keyframe's passes; one with no target where the rank has none
  const int passes = max(1, (hi - lo + kDenseStage - 1) / kDenseStage);
  const int q = threadIdx.x / kDenseRowThreads;
  const int l = threadIdx.x % kDenseRowThreads;
  const float2* t2 = reinterpret_cast<const float2*>(tar);

  // Pass p of keyframe s into stage k: thread u copies units u, u +
  // kDenseThreads, ... of 4 targets (two 16-byte copies) and their 4 valid
  // bytes, or, where M % 4 != 0, loads the unit's targets below M one by
  // one and packs their valid bytes; units past M (the padded tail) are
  // left to `fix`.
  const bool aligned = M % kCopyUnit == 0;
  auto copy = [&](int s, int p, int k) {
    const int base = lo + p * kDenseStage;
    const int n = min(kDenseStage, hi - base);
    const size_t bs = static_cast<size_t>(lane) * s_n + s;
    float2* st = reinterpret_cast<float2*>(ring[k]);
    for (int u = threadIdx.x; u < n / kCopyUnit; u += kDenseThreads) {
      const int g = base + u * kCopyUnit;
      if (g < M) {
        const size_t o = bs * M + g;
        if (aligned) {
          cp_async16(st + u * kCopyUnit, t2 + o);
          cp_async16(st + u * kCopyUnit + 2, t2 + o + 2);
          cp_async4(&vring[k][u], valid + o);
        } else {
          unsigned v4 = 0u;
          for (int b = 0; b < kCopyUnit && g + b < M; ++b) {
            st[u * kCopyUnit + b] = t2[o + b];
            v4 |= static_cast<unsigned>(valid[o + b] != 0) << (8 * b);
          }
          vring[k][u] = v4;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // after this thread's copies of pass p in stage k have landed: its own
  // invalid and padding targets to (+inf, +inf)
  auto fix = [&](int p, int k) {
    const int base = lo + p * kDenseStage;
    const int n = min(kDenseStage, hi - base);
    float2* st = reinterpret_cast<float2*>(ring[k]);
    for (int u = threadIdx.x; u < n / kCopyUnit; u += kDenseThreads) {
      const unsigned v4 = base + u * kCopyUnit < M ? vring[k][u] : 0u;
#pragma unroll
      for (int b = 0; b < kCopyUnit; ++b)
        if (!((v4 >> (8 * b)) & 0xffu))
          st[u * kCopyUnit + b] = make_float2(CUDART_INF_F, CUDART_INF_F);
    }
  };

  const float2* s2 = reinterpret_cast<const float2*>(src) + static_cast<size_t>(lane) * Msrc;
  float sx[kDenseRows], sy[kDenseRows], bv[kDenseRows];
  int bg[kDenseRows], bi[kDenseRows];
#pragma unroll
  for (int j = 0; j < kDenseRows; ++j) {
    const int row = tile * kDenseTile + l + j * kDenseRowThreads;
    const float2 p = row < Msrc ? s2[row] : make_float2(0.f, 0.f);
    sx[j] = p.x;
    sy[j] = p.y;
  }
  const int rows = min(kDenseTile, Msrc - tile * kDenseTile);

  // Pass p of keyframe s in stage k: wait for this thread's copies and fix
  // them; one barrier (every thread has also left the pass before, which
  // read the other stage); start the next pass's copies into the other
  // stage; scan, rescan the rows whose best moved in this pass. After a
  // keyframe's last pass merge the slices and ranks and write.
  int k = 0;
  copy(s0, 0, 0);
#pragma unroll (kS > 0 ? kS : 1)
  for (int i = 0; i < s_n; ++i) {
    const int s = s0 + i;
    if (s >= s_end) break;
#pragma unroll
    for (int j = 0; j < kDenseRows; ++j) {
      bv[j] = CUDART_INF_F;
      bg[j] = -1;
      bi[j] = 0;
    }
    for (int p = 0; p < passes; ++p) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      fix(p, k);
      __syncthreads();
      if (p + 1 < passes) {
        copy(s, p + 1, k ^ 1);
      } else if (s + 1 < s_end) {
        copy(s + 1, 0, k ^ 1);
      }
      const int base = lo + p * kDenseStage;
      scan_dense_pass(ring[k], base, min(kDenseStage, hi - base), q, sx, sy,
                      bv, bg);
      rescan_dense(reinterpret_cast<const float2*>(ring[k]), base, sx, sy, bv,
                   bg, bi);
      k ^= 1;
    }
    merge_dense(part_d, part_i, res_d, res_i, q, l, bv, bi, C, rank,
                (static_cast<size_t>(lane) * s_n + s) * Msrc + tile * kDenseTile,
                rows, nn, d2);
  }
}

struct DenseWalkArgs {
  const float *src, *tar;
  const unsigned char* valid;
  int B, S, Msrc, M, G, C;
  int* nn;
  float* d2;
  cudaStream_t stream;
};

// Launch B1 (kS = 0) or B2 for kS keyframes; returns the CUDA error,
// cudaErrorInvalidValue without launching for a group count outside [1,
// S], a cluster size other than 1, 2, 4 or 8, or one above 1 with G != S
// or above the keyframe's chunks.
template <int kS>
int launch_dense_walk(const DenseWalkArgs& a) {
  const int nc = (a.M + kDenseChunk - 1) / kDenseChunk;
  if (a.G < 1 || a.G > a.S || (a.C != 1 && a.C != 2 && a.C != 4 && a.C != 8) ||
      (a.C > 1 && (a.G != a.S || a.C > nc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.C * a.B * a.G, (a.Msrc + kDenseTile - 1) / kDenseTile);
  config.blockDim = dim3(kDenseThreads);
  config.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = a.C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, nn_min_dense_walk_kernel<kS>, a.src, a.tar, a.valid, a.S,
      a.Msrc, a.M, a.G, a.C, a.nn, a.d2);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// B2 for whichever keyframe count in CFEAR_UNROLLED_S_MASK, from kS down
// to 1, equals S; when none does, the runtime-count instance (B1's: the
// same scan, the same bits).
template <int kS>
int launch_dense_unrolled(const DenseWalkArgs& a) {
  if constexpr (kS == 0) {
    return launch_dense_walk<0>(a);
  } else {
    if constexpr (((CFEAR_UNROLLED_S_MASK) >> kS) & 1) {
      if (a.S == kS) return launch_dense_walk<kS>(a);
    }
    return launch_dense_unrolled<kS - 1>(a);
  }
}

// Kernel E's first form (`split` 0: kept for the shapes
// ops/cuda_assoc.py:sparse_split gives it, as C's).
// grid (B*S, Msrc / kTileS), block kTileS: kernel C, then each
// thread copies its winner's attribute column attrs_t[bs, :, barg] (D_pad
// values) to g[bs, :, row]; zeros where the row's best never improved
// (d2 = +inf: every tile pair skipped or no valid target).
__global__ void nn_min_sparse_attrs_kernel(const float* __restrict__ src,
                                           const float* __restrict__ src_bounds,
                                           const float* __restrict__ tar,
                                           const float* __restrict__ tar_bounds,
                                           const unsigned char* __restrict__ valid,
                                           const float* __restrict__ attrs_t,
                                           const float* __restrict__ radius,
                                           int S, int Msrc, int M, int Dpad,
                                           int* __restrict__ nn,
                                           float* __restrict__ d2,
                                           float* __restrict__ g) {
  __shared__ TileBuf sh;
  const int bs = blockIdx.x;
  const SrcTile st = load_src_tile(src, src_bounds, radius, bs / S, blockIdx.y, Msrc);
  const Keyframe kf = keyframe(tar, valid, tar_bounds, bs, M);
  float best = CUDART_INF_F;
  int barg = 0;
  for (int jt = 0; jt < M / kTileT; ++jt) scan_tile(st, kf.t, kf.v, kf.tb, jt, sh, best, barg);
  const int row = blockIdx.y * kTileS + threadIdx.x;
  const size_t o = static_cast<size_t>(bs) * Msrc + row;
  nn[o] = barg;
  d2[o] = best;
  const bool hit = best < CUDART_INF_F;
  const float* a = attrs_t + static_cast<size_t>(bs) * Dpad * M + barg;
  float* go = g + static_cast<size_t>(bs) * Dpad * Msrc + row;
  for (int d = 0; d < Dpad; ++d) go[static_cast<size_t>(d) * Msrc] = hit ? a[static_cast<size_t>(d) * M] : 0.f;
}

struct WalkArgs {
  const float *src, *src_bounds, *tar, *tar_bounds;
  const unsigned char* valid;
  const float* radius;
  int B, S, Msrc, M, G;
  int* nn;
  float* d2;
  cudaStream_t stream;
};

// Launch D1 (kNT = 0) or D2 for kNT target tiles; returns the CUDA error,
// cudaErrorInvalidValue without launching for a group count outside [1, S].
template <int kNT>
int launch_walk(const WalkArgs& a) {
  if (a.G < 1 || a.G > a.S) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = a.M / kTileT < kMaxTilesC ? a.M / kTileT : kMaxTilesC;
  const size_t smem = static_cast<size_t>(2) * cap * kTileT * (sizeof(float2) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nn_min_sparse_walk_kernel<kNT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nn_min_sparse_walk_kernel<kNT><<<dim3(a.B * a.G, a.Msrc / kTileS), kThreadsC,
                                   smem, a.stream>>>(
      a.src, a.src_bounds, a.tar, a.tar_bounds, a.valid, a.radius, a.S, a.Msrc,
      a.M, a.G, a.nn, a.d2);
  return static_cast<int>(cudaGetLastError());
}

struct SplitArgs {
  const float *src, *src_bounds, *tar, *tar_bounds;
  const unsigned char* valid;
  const float* radius;
  int B, S, Msrc, M, split;
  int* nn;
  float* d2;
  const float* attrs_t;   // kernel E's; C passes nullptr, 0, nullptr
  int Dpad;
  float* g;
  cudaStream_t stream;
};

// Launch kernel C's (kAttrs = false) or E's (true) instance of the split
// kernel with a cluster of `split` CTAs; returns the CUDA error,
// cudaErrorInvalidValue without launching for a split other than 1, 2, 4
// or 8, above M / 512 (when above 1), or leaving a CTA more than
// kMaxTilesC target tiles.
template <bool kAttrs>
int launch_split(const SplitArgs& a) {
  if (a.split != 1 && a.split != 2 && a.split != 4 && a.split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = a.M / kTileT;
  const int tiles = (nt + a.split - 1) / a.split;   // the most any rank takes
  if ((a.split > 1 && a.split > nt) || tiles > kMaxTilesC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.split * a.B * a.S, a.Msrc / kTileS);
  config.blockDim = dim3(kThreadsC);
  config.dynamicSmemBytes = static_cast<size_t>(tiles) * kTileT * sizeof(float2);
  config.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = a.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, nn_min_sparse_split_kernel<kAttrs>, a.src, a.src_bounds, a.tar,
      a.tar_bounds, a.valid, a.radius, a.S, a.Msrc, a.M, a.split, a.nn, a.d2,
      a.attrs_t, a.Dpad, a.g);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// D2 for whichever tile count in CFEAR_UNROLLED_MASK, from kNT down to 1,
// matches M; when none does, the runtime-count instance (D1's: the same
// scan, the same bits).
template <int kNT>
int launch_unrolled(const WalkArgs& a) {
  if constexpr (kNT == 0) {
    return launch_walk<0>(a);
  } else {
    if constexpr (((CFEAR_UNROLLED_MASK) >> kNT) & 1) {
      if (a.M == kNT * kTileT) return launch_walk<kNT>(a);
    }
    return launch_unrolled<kNT - 1>(a);
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
// Kernel A. `split` is the cluster size (1, 2, 4 or 8 CTAs per keyframe
// and source tile, at most ceil(M / kDenseChunk) when above 1);
// ops/cuda_assoc.py:dense_split picks it from the shape. Any other value
// returns cudaErrorInvalidValue without launching. Any Msrc and M.
int cfear_nn_min(const float* src, const float* tar, const unsigned char* valid,
                 int B, int S, int Msrc, int M, int split, int* nn, float* d2,
                 void* stream) {
  const int nc = (M + kDenseChunk - 1) / kDenseChunk;
  if ((split != 1 && split != 2 && split != 4 && split != 8) ||
      (split > 1 && split > nc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(split * B * S, (Msrc + kDenseTile - 1) / kDenseTile);
  config.blockDim = dim3(kDenseThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, nn_min_dense_kernel, src,
                                             tar, valid, S, Msrc, M, split, nn, d2);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Kernels B1 and B2. `groups` is the number of keyframe groups a lane's
// keyframes are cut into (1 to S) and `split` the cluster size (1, 2, 4 or
// 8 CTAs per keyframe and source tile, above 1 only with groups = S and at
// most ceil(M / kDenseChunk)); ops/cuda_assoc.py:multi_split picks both
// from the shape. Any other value returns cudaErrorInvalidValue without
// launching. src 8-byte, tar 16-byte and valid 4-byte aligned (the wrapper
// checks). Any Msrc and M.
int cfear_nn_min_multi(const float* src, const float* tar,
                       const unsigned char* valid, int B, int S, int Msrc,
                       int M, int groups, int split, int* nn, float* d2,
                       void* stream) {
  return launch_dense_walk<0>({src, tar, valid, B, S, Msrc, M, groups, split,
                               nn, d2, static_cast<cudaStream_t>(stream)});
}

// B2: S one of the keyframe counts it is built for (CFEAR_UNROLLED_S_MASK)
// launches that instance, any other S the runtime-count one.
int cfear_nn_min_multi_unrolled(const float* src, const float* tar,
                                const unsigned char* valid, int B, int S,
                                int Msrc, int M, int groups, int split,
                                int* nn, float* d2, void* stream) {
  return launch_dense_unrolled<16>({src, tar, valid, B, S, Msrc, M, groups,
                                    split, nn, d2,
                                    static_cast<cudaStream_t>(stream)});
}

// Kernel C. `split` is the cluster size of the split kernel (1, 2, 4 or 8
// CTAs per keyframe and source tile, at most M / 512 and with at most
// CFEAR_SPLIT_MAX_TILES target tiles a CTA), or 0 for the one-block-per-
// tile-pair kernel `nn_min_sparse_kernel`; ops/cuda_assoc.py:sparse_split
// picks it from the shape. Any other value returns cudaErrorInvalidValue
// without launching.
int cfear_nn_min_sparse(const float* src, const float* src_bounds,
                        const float* tar, const float* tar_bounds,
                        const unsigned char* valid, const float* radius,
                        int B, int S, int Msrc, int M, int split, int* nn,
                        float* d2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split == 0) {
    nn_min_sparse_kernel<<<dim3(B * S, Msrc / kTileS), kTileS, 0, st>>>(
        src, src_bounds, tar, tar_bounds, valid, radius, S, Msrc, M, nn, d2);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_split<false>({src, src_bounds, tar, tar_bounds, valid, radius,
                              B, S, Msrc, M, split, nn, d2, nullptr, 0,
                              nullptr, st});
}

// Kernels D1 and D2. `groups` is the number of keyframe groups a lane's
// keyframes are cut into (1 to S; ops/cuda_assoc.py:walk_groups picks it
// from the shape); any other value returns cudaErrorInvalidValue without
// launching. src 8-byte, tar 16-byte and valid 4-byte aligned (the wrapper
// checks). D1 takes any M % 512 == 0.
int cfear_nn_min_sparse_multi(const float* src, const float* src_bounds,
                              const float* tar, const float* tar_bounds,
                              const unsigned char* valid, const float* radius,
                              int B, int S, int Msrc, int M, int groups, int* nn,
                              float* d2, void* stream) {
  return launch_walk<0>({src, src_bounds, tar, tar_bounds, valid, radius, B, S,
                         Msrc, M, groups, nn, d2,
                         static_cast<cudaStream_t>(stream)});
}

// D2: M one of the budgets it is built for (CFEAR_UNROLLED_MASK) launches
// that instance, any other M % 512 == 0 the runtime-count one.
int cfear_nn_min_sparse_unrolled(const float* src, const float* src_bounds,
                                 const float* tar, const float* tar_bounds,
                                 const unsigned char* valid, const float* radius,
                                 int B, int S, int Msrc, int M, int groups,
                                 int* nn, float* d2, void* stream) {
  return launch_unrolled<30>({src, src_bounds, tar, tar_bounds, valid, radius,
                              B, S, Msrc, M, groups, nn, d2,
                              static_cast<cudaStream_t>(stream)});
}

// Kernel E. `split` is kernel C's, from the same rule
// (ops/cuda_assoc.py:sparse_split): 1, 2, 4 or 8 runs the split kernel's E
// instance with that cluster size and C's limits, 0 the one-block-per-
// tile-pair `nn_min_sparse_attrs_kernel`. Dpad is a positive multiple of 8.
// Any other value returns cudaErrorInvalidValue without launching.
int cfear_nn_min_sparse_attrs(const float* src, const float* src_bounds,
                              const float* tar, const float* tar_bounds,
                              const unsigned char* valid, const float* attrs_t,
                              const float* radius, int B, int S, int Msrc,
                              int M, int Dpad, int split, int* nn, float* d2,
                              float* g, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dpad <= 0 || Dpad % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (split == 0) {
    nn_min_sparse_attrs_kernel<<<dim3(B * S, Msrc / kTileS), kTileS, 0, st>>>(
        src, src_bounds, tar, tar_bounds, valid, attrs_t, radius, S, Msrc, M,
        Dpad, nn, d2, g);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_split<true>({src, src_bounds, tar, tar_bounds, valid, radius,
                             B, S, Msrc, M, split, nn, d2, attrs_t, Dpad, g,
                             st});
}

}  // extern "C"
