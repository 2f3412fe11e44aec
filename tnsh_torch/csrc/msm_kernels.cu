// BN254 G1 kernels for Hopper (sm_90a): the commitment MSM on the card.
//
// Field arithmetic over Fq and the element layout are in field.cuh (shared
// with fr_kernels.cu).  A G1 point is three (8, N) Fq tables X, Y, Z in
// Jacobian coordinates (infinity: Z = 0), or two tables x, y when affine.
//
//   fe_chain_kernel<FqField>  Fq Montgomery product per lane (field.cuh);
//                             converts the SRS bases to Montgomery form.
//   g1_padd_kernel            general Jacobian add per lane (g1_add: the
//                             equal-point doubling and both infinities),
//                             with an optional lane mask (XLA code in
//                             tnsh/commit/msm_jax.py _padd).  The route of
//                             tree_reduce_points and of the level-wise
//                             tail; the MSM itself no longer calls it.
//   msm_insert_kernel         <- tnsh/commit/msm_sched.py
//                             _make_insert_seg_cached / seg_kernel, the
//                             scheduled bucket insertion (TPU kernel #5).
//   msm_fold_tiles_kernel     the MSM's tail: the fold of each group's
//   msm_window_sums_kernel    lanes, the gather into the canonical bucket
//                             layout and per window sum_d d*B_d (XLA code
//                             in tnsh/commit/msm_sched.py
//                             _compiled_msm_kernel_pallas_cached, stage C:
//                             the group fold, the canon_src gather,
//                             _window_sums).
//   msm_digits_kernel         the MSM's plan on the card: signed base-256
//   msm_rank_kernel           digits, their (chunk, window, magnitude)
//                             counts and the insertion schedule (host numpy
//                             in tnsh/commit/msm_sched.py signed_digits and
//                             MsmPlan, and an XLA one-hot cumsum in
//                             _compiled_msm_kernel_pallas_cached; no TPU
//                             kernel).
//
// Every entry point is a plain C function (bound with ctypes), launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().
//
// The insertion on the TPU is a sequential grid over the scheduled steps:
// the accumulators stay in VMEM, and XLA gathers each step's points into a
// dense (seg, 22, 4096) stream beforehand because Mosaic cannot gather.
// Here the step loop runs inside the thread.  One thread owns one
// accumulator lane, keeps X, Y, Z (24 words) in registers over all the
// steps of a chunk, reads its schedule entry for the step and gathers its
// own point from the chunk's planes: no gathered stream is materialised,
// and steps past the chunk's own count are never visited.  A lane whose
// accumulator equals the incoming point, where the mixed add is wrong,
// doubles instead (a branch the Pallas kernel could not take) and is
// counted; the count is an integer atomicAdd, so its order does not matter.
//
// What bounds the insertion: operations, and before that occupancy.  A
// step is 11 Fq products (1,496 32-bit multiply instructions) a lane
// against 68 bytes read, so memory is far away; a thread's steps are one
// dependent chain, so only other resident warps hide a product's latency.
// The work (one mixed add a schedule entry) is fixed by the digits; its
// shape is the plan's: lanes x steps.  So the plan is made as wide as the
// card: tnsh_msm_insert_resident_threads says how many threads of this
// kernel the card keeps resident (the occupancy calculator's blocks an SM
// x SMs x block size), the host rounds that down to a power of two and
// plans with it, and one launch is one wave of the card with a thread a
// lane and a few tens of steps instead of hundreds.
//
// What bounds the tail: latency.  By operations it is tiny (one general
// add of 16 products for every lane folded away, and 2 x 127 adds a
// window), but the adds form a chain: log2 K fold levels for the widest
// group, then 7 levels of suffix scan and 7 of tree sum, each level one
// general add deep.  Run level by level as tensor ops, every level costs a
// launch and three rolled copies through device memory, in which most
// lanes only copy.  Here a 256-lane tile of points lives in shared memory
// (24 KB, limb-major) for eight fold levels, with a block barrier between
// levels and the active lanes of a level compacted onto the first threads,
// so warps stay full whatever the plan: a bit column, whose one group
// holds nearly every lane, is folded by all tiles at once.  Groups start
// at multiples of their size (the plan packs them so), so a group of up to
// 256 lanes lies in one tile; a wider one leaves a partial a tile, and a
// second launch of the same kernel folds the partials (stride 256) in one
// more tile.  The window kernel then gathers a window's 128 buckets into
// shared memory and runs scan and tree there, one block a window.  Two or
// three launches take the place of some hundred.

#include "field.cuh"

namespace {

using namespace tnsh;

// R mod q: the Montgomery form of 1 in Fq.
__constant__ uint32_t kFqOne[L] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};

#define fq_add fe_add<FqField>
#define fq_sub fe_sub<FqField>
#define fq_mul fe_mul<FqField>
#define fq_is_zero fe_is_zero<FqField>

// 2P in Jacobian coordinates; infinity (Z = 0) maps to infinity.
__device__ __forceinline__ void g1_double(uint32_t X3[L], uint32_t Y3[L],
                                          uint32_t Z3[L], const uint32_t X[L],
                                          const uint32_t Y[L],
                                          const uint32_t Z[L]) {
  uint32_t A[L], B[L], C[L], D[L], E[L], F[L], T[L];
  fq_mul(A, X, X);
  fq_mul(B, Y, Y);
  fq_add(T, X, B);      // XB
  fq_mul(C, B, B);
  fq_mul(T, T, T);      // T = XB^2
  fq_mul(F, Y, Z);      // YZ
  fq_add(Z3, F, F);
  fq_sub(T, T, A);
  fq_sub(T, T, C);      // TAC
  fq_add(D, T, T);
  fq_add(E, A, A);
  fq_add(E, E, A);
  fq_mul(F, E, E);
  fq_add(T, D, D);
  fq_sub(X3, F, T);
  fq_sub(T, D, X3);
  fq_mul(T, E, T);      // EDX
  fq_add(C, C, C);
  fq_add(C, C, C);
  fq_add(C, C, C);      // 8C
  fq_sub(Y3, T, C);
}

// ---------------------------------------------------------------------------
// General Jacobian add: P3 = P1 + P2.  Handles P1 or P2 at infinity (the
// other operand is returned limb for limb), inverse points (the formula
// gives Z3 = 0) and equal points (doubling).  P3 must not alias an input.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void g1_add(
    uint32_t X3[L], uint32_t Y3[L], uint32_t Z3[L], const uint32_t X1[L],
    const uint32_t Y1[L], const uint32_t Z1[L], const uint32_t X2[L],
    const uint32_t Y2[L], const uint32_t Z2[L]) {
  if (fq_is_zero(Z1)) {
    fe_copy(X3, X2);
    fe_copy(Y3, Y2);
    fe_copy(Z3, Z2);
    return;
  }
  if (fq_is_zero(Z2)) {
    fe_copy(X3, X1);
    fe_copy(Y3, Y1);
    fe_copy(Z3, Z1);
    return;
  }
  uint32_t Z1Z1[L], Z2Z2[L], U1[L], U2[L], S1[L], S2[L], H[L], r[L];
  fq_mul(Z1Z1, Z1, Z1);
  fq_mul(Z2Z2, Z2, Z2);
  fq_mul(U1, X1, Z2Z2);
  fq_mul(U2, X2, Z1Z1);
  fq_mul(S1, Y1, Z2);
  fq_mul(S2, Y2, Z1);
  fq_mul(S1, S1, Z2Z2);
  fq_mul(S2, S2, Z1Z1);
  fq_sub(H, U2, U1);
  fq_sub(r, S2, S1);     // r0
  if (fq_is_zero(H) && fq_is_zero(r)) {
    g1_double(X3, Y3, Z3, X1, Y1, Z1);
    return;
  }
  uint32_t I[L], J[L], V[L], T[L];
  fq_add(r, r, r);
  fq_add(I, H, H);       // H2
  fq_mul(I, I, I);
  fq_mul(T, r, r);       // RR
  fq_mul(J, H, I);
  fq_mul(V, U1, I);
  fq_mul(Z3, Z1, Z2);    // ZZ
  fq_sub(X3, T, J);
  fq_add(T, V, V);
  fq_sub(X3, X3, T);
  fq_sub(T, V, X3);
  fq_mul(T, r, T);       // RVX
  fq_mul(J, S1, J);      // SJ
  fq_mul(Z3, Z3, H);     // ZZH
  fq_add(J, J, J);
  fq_sub(Y3, T, J);
  fq_add(Z3, Z3, Z3);
}

// ---------------------------------------------------------------------------
// The add as a tensor op: out = P1 + P2 where mask is set (or everywhere
// without a mask), else P1.
// ---------------------------------------------------------------------------
__global__ void g1_padd_kernel(const uint32_t* __restrict__ x1,
                               const uint32_t* __restrict__ y1,
                               const uint32_t* __restrict__ z1,
                               const uint32_t* __restrict__ x2,
                               const uint32_t* __restrict__ y2,
                               const uint32_t* __restrict__ z2,
                               const unsigned char* __restrict__ mask,
                               uint32_t* __restrict__ ox,
                               uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t X1[L], Y1[L], Z1[L];
    fe_load(X1, x1 + i, n);
    fe_load(Y1, y1 + i, n);
    fe_load(Z1, z1 + i, n);
    if (mask != nullptr && !mask[i]) {
      fe_store(ox + i, n, X1);
      fe_store(oy + i, n, Y1);
      fe_store(oz + i, n, Z1);
      continue;
    }
    uint32_t X2[L], Y2[L], Z2[L], X3[L], Y3[L], Z3[L];
    fe_load(X2, x2 + i, n);
    fe_load(Y2, y2 + i, n);
    fe_load(Z2, z2 + i, n);
    g1_add(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
    fe_store(ox + i, n, X3);
    fe_store(oy + i, n, Y3);
    fe_store(oz + i, n, Z3);
  }
}

// ---------------------------------------------------------------------------
// Scheduled bucket insertion (replaces msm_sched.seg_kernel).
//
// sched is (steps, lanes) int32: entry 0 leaves the lane untouched, entry
// +-(i + 1) adds point i of the chunk, negated when the entry is negative.
// px, py are the chunk's affine Montgomery planes, limb k of point i at
// px[k * pstride + i] (a column slice of the context's (8, n_pad) bases).
// Each step is one mixed Jacobian + affine add; an accumulator at infinity
// takes the point; a lane whose accumulator equals the incoming point
// doubles and adds one to *hazards.
//
// 128 threads a block and no register cap: with the product in PTX carry
// chains ptxas takes 114 registers, so four blocks fit an SM and the width
// derived on an H100 is 65,536 lanes (the C++ product took 154: three
// blocks, 32,768 lanes).  A thread's steps are one dependent chain, so the
// resident warps of a scheduler are what hides a product's latency.
// ---------------------------------------------------------------------------
constexpr int kInsertThreads = 128;

__global__ void __launch_bounds__(kInsertThreads)
msm_insert_kernel(const int* __restrict__ sched, long long lanes, int steps,
                  const uint32_t* __restrict__ px,
                  const uint32_t* __restrict__ py, long long pstride,
                  long long m, const uint32_t* __restrict__ inx,
                  const uint32_t* __restrict__ iny,
                  const uint32_t* __restrict__ inz, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                  int* __restrict__ hazards) {
  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t X1[L], Y1[L], Z1[L];
  fe_load(X1, inx + lane, lanes);
  fe_load(Y1, iny + lane, lanes);
  fe_load(Z1, inz + lane, lanes);
  int hz = 0;
  for (int s = 0; s < steps; ++s) {
    const int e = sched[(long long)s * lanes + lane];
    if (e == 0) continue;
    long long idx = (long long)(e < 0 ? -(long long)e : (long long)e) - 1;
    if (idx > m - 1) idx = m - 1;
    uint32_t x2[L], y2[L];
    fe_load(x2, px + idx, pstride);
    fe_load(y2, py + idx, pstride);
    if (e < 0) {
      uint32_t zero[L];
      fe_zero(zero);
      fq_sub(y2, zero, y2);
    }
    if (fq_is_zero(Z1)) {
      fe_copy(X1, x2);
      fe_copy(Y1, y2);
#pragma unroll
      for (int k = 0; k < L; ++k) Z1[k] = kFqOne[k];
      continue;
    }
    uint32_t Z1Z1[L], H[L], r[L], I[L], J[L], V[L], T[L];
    fq_mul(Z1Z1, Z1, Z1);
    fq_mul(H, x2, Z1Z1);   // U2
    fq_mul(T, y2, Z1);     // T2
    fq_mul(T, T, Z1Z1);    // S2
    fq_sub(H, H, X1);
    fq_sub(r, T, Y1);      // r0
    if (fq_is_zero(H) && fq_is_zero(r)) {
      ++hz;
      g1_double(I, J, V, X1, Y1, Z1);
      fe_copy(X1, I);
      fe_copy(Y1, J);
      fe_copy(Z1, V);
      continue;
    }
    fq_add(r, r, r);
    fq_add(I, H, H);       // H2
    fq_mul(I, I, I);
    fq_mul(T, r, r);       // RR
    fq_mul(J, H, I);
    fq_mul(V, X1, I);
    fq_mul(Z1, Z1, H);     // Z1H
    fq_add(Z1, Z1, Z1);    // Z3
    fq_sub(X1, T, J);
    fq_add(T, V, V);
    fq_sub(X1, X1, T);     // X3
    fq_sub(T, V, X1);
    fq_mul(T, r, T);       // RVX
    fq_mul(J, Y1, J);      // SJ
    fq_add(J, J, J);
    fq_sub(Y1, T, J);      // Y3
  }
  fe_store(ox + lane, lanes, X1);
  fe_store(oy + lane, lanes, Y1);
  fe_store(oz + lane, lanes, Z1);
  if (hz) atomicAdd(hazards, hz);
}

// ---------------------------------------------------------------------------
// The tail, stage A: eight levels of the group fold inside a tile.
//
// The pass at level t0 works on the lanes that are multiples of 2^t0 (each
// holds the sum of its group's lanes [lane, lane + 2^t0) from the pass
// before; t0 = 0 works on every lane).  A block loads 256 such elements
// into shared memory and runs levels t0 .. t0 + 7: level t adds element
// i + 2^(t - t0) into element i where i is a multiple of 2^(t - t0 + 1)
// and its lane's group has more than 2^t lanes (lane_logk > t).  The
// active elements of a level are handed to the first threads of the
// block.  It stops at the first level at which no group of the tile is
// that wide.  An element is written back where it is its group's base or,
// for a group wider than the pass reaches, the tile's first; in and out
// may be the same buffers (a block reads only what it writes).
// ---------------------------------------------------------------------------
constexpr int kTile = 256;

__device__ __forceinline__ void sm_load(uint32_t r[L], const uint32_t* plane,
                                        int width, int i) {
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = plane[k * width + i];
}

__device__ __forceinline__ void sm_store(uint32_t* plane, int width, int i,
                                         const uint32_t r[L]) {
#pragma unroll
  for (int k = 0; k < L; ++k) plane[k * width + i] = r[k];
}

__global__ void __launch_bounds__(kTile)
msm_fold_tiles_kernel(const uint32_t* inx, const uint32_t* iny,
                      const uint32_t* inz,
                      const unsigned char* __restrict__ lane_logk,
                      uint32_t* ox, uint32_t* oy, uint32_t* oz,
                      long long lanes, int t0) {
  __shared__ uint32_t sx[L * kTile], sy[L * kTile], sz[L * kTile];
  __shared__ unsigned char sk[kTile];
  const int tid = threadIdx.x;
  const long long elem = (long long)blockIdx.x * kTile + tid;
  const long long lane = elem << t0;
  const bool live = lane < lanes;
  int lk = 0;
  {
    uint32_t P[L];
    fe_zero(P);
    if (live) {
      lk = lane_logk[lane];
      fe_load(P, inx + lane, lanes);
      sm_store(sx, kTile, tid, P);
      fe_load(P, iny + lane, lanes);
      sm_store(sy, kTile, tid, P);
      fe_load(P, inz + lane, lanes);
      sm_store(sz, kTile, tid, P);
    } else {
      sm_store(sx, kTile, tid, P);
      sm_store(sy, kTile, tid, P);
      sm_store(sz, kTile, tid, P);   // Z = 0: infinity
    }
  }
  sk[tid] = (unsigned char)lk;
#pragma unroll 1
  for (int s = 0; s < 8; ++s) {
    const int t = t0 + s;
    // a barrier between levels, and the vote whether this one has work
    if (!__syncthreads_or(lk > t)) break;
    if (tid < (kTile >> (s + 1))) {
      const int i = tid << (s + 1);
      if (sk[i] > t) {
        const int j = i + (1 << s);
        uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], Z2[L];
        uint32_t X3[L], Y3[L], Z3[L];
        sm_load(X1, sx, kTile, i);
        sm_load(Y1, sy, kTile, i);
        sm_load(Z1, sz, kTile, i);
        sm_load(X2, sx, kTile, j);
        sm_load(Y2, sy, kTile, j);
        sm_load(Z2, sz, kTile, j);
        g1_add(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
        sm_store(sx, kTile, i, X3);
        sm_store(sy, kTile, i, Y3);
        sm_store(sz, kTile, i, Z3);
      }
    }
  }
  __syncthreads();
  if (live) {
    const int span = lk < t0 + 8 ? lk : t0 + 8;
    if ((lane & ((1LL << span) - 1)) == 0) {
      uint32_t P[L];
      sm_load(P, sx, kTile, tid);
      fe_store(ox + lane, lanes, P);
      sm_load(P, sy, kTile, tid);
      fe_store(oy + lane, lanes, P);
      sm_load(P, sz, kTile, tid);
      fe_store(oz + lane, lanes, P);
    }
  }
}

// ---------------------------------------------------------------------------
// The tail, stage B: one block a window.  Thread b takes the bucket of
// digit magnitude b + 1 from its group's base lane (infinity where the
// plan has no such group), the block turns the 128 buckets into their
// inclusive suffix sums S_b (Hillis-Steele, 7 levels) and adds those up (a
// tree, 7 levels): sum_b S_b = sum_d d * B_d.  out is (8, 3W + 1): the
// window's sum as X | Y | Z in columns w, W + w, 2W + w, and the hazard
// count in limb 0 of the last column.
// ---------------------------------------------------------------------------
constexpr int kBuckets = 128;

__global__ void __launch_bounds__(kBuckets)
msm_window_sums_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ z, long long lanes,
                       const int* __restrict__ canon_src,
                       const unsigned char* __restrict__ canon_mask,
                       int w_count, const int* __restrict__ hazards,
                       uint32_t* __restrict__ out) {
  __shared__ uint32_t sx[L * kBuckets], sy[L * kBuckets], sz[L * kBuckets];
  const int w = blockIdx.x, b = threadIdx.x;
  const long long width = 3LL * w_count + 1;
  uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], Z2[L], X3[L], Y3[L], Z3[L];
  if (canon_mask[w * kBuckets + b]) {
    const long long src = canon_src[w * kBuckets + b];
    fe_load(X1, x + src, lanes);
    fe_load(Y1, y + src, lanes);
    fe_load(Z1, z + src, lanes);
  } else {
    fe_zero(X1);
    fe_zero(Z1);
#pragma unroll
    for (int k = 0; k < L; ++k) Y1[k] = kFqOne[k];
  }
  sm_store(sx, kBuckets, b, X1);
  sm_store(sy, kBuckets, b, Y1);
  sm_store(sz, kBuckets, b, Z1);
  // suffix scan: every thread reads its partner before anyone writes
#pragma unroll 1
  for (int sh = 1; sh < kBuckets; sh <<= 1) {
    const bool active = b + sh < kBuckets;
    __syncthreads();
    if (active) {
      sm_load(X2, sx, kBuckets, b + sh);
      sm_load(Y2, sy, kBuckets, b + sh);
      sm_load(Z2, sz, kBuckets, b + sh);
    }
    __syncthreads();
    if (active) {
      g1_add(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
      fe_copy(X1, X3);
      fe_copy(Y1, Y3);
      fe_copy(Z1, Z3);
      sm_store(sx, kBuckets, b, X1);
      sm_store(sy, kBuckets, b, Y1);
      sm_store(sz, kBuckets, b, Z1);
    }
  }
  // tree sum: threads below sh write, [sh, 2 sh) are only read
#pragma unroll 1
  for (int sh = kBuckets / 2; sh >= 1; sh >>= 1) {
    __syncthreads();
    if (b < sh) {
      sm_load(X2, sx, kBuckets, b + sh);
      sm_load(Y2, sy, kBuckets, b + sh);
      sm_load(Z2, sz, kBuckets, b + sh);
      g1_add(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
      fe_copy(X1, X3);
      fe_copy(Y1, Y3);
      fe_copy(Z1, Z3);
      sm_store(sx, kBuckets, b, X1);
      sm_store(sy, kBuckets, b, Y1);
      sm_store(sz, kBuckets, b, Z1);
    }
  }
  if (b == 0) {
    fe_store(out + w, width, X1);
    fe_store(out + w_count + w, width, Y1);
    fe_store(out + 2 * w_count + w, width, Z1);
    if (w == 0) {
      uint32_t last[L];
      fe_zero(last);
      last[0] = (uint32_t)*hazards;
      fe_store(out + 3 * w_count, width, last);
    }
  }
}

constexpr int kPointThreads = 128;

// ---------------------------------------------------------------------------
// The plan, stage A: signed digits and their counts (replaces the host's
// signed_digits and MsmPlan's counting; no TPU kernel: tnsh plans in numpy).
//
// words is (n, 8) uint32, the scalars' standard-form little-endian bytes.
// Each thread takes scalars of its block's tile and walks their 32 bytes
// low to high with a carry: v = byte + carry, carry = v >= 128, digit =
// v - 256 carry, so digits lie in [-128, 127] and sum_w d_w 256^w is the
// scalar.  digits is (32, n_ck) int8, window-major (the chunk's points of
// a window side by side, as the rank kernel reads them); points past n and
// points whose base is not valid get zero digits (valid may be null: every
// base is a point).  The nonzero digits are
// counted by (window, |digit|) in a shared-memory histogram of the block
// (32 x 129 ints) and added once a block into the chunk's row of counts
// (chunks, 32, 129), which the caller zeroed; a block's tile lies in one
// chunk.  meta[0..7] is the OR of every scalar's words (from which the host
// takes W, the windows up to the highest nonzero byte and a carry window),
// meta[8] is nonzero where a scalar carries out of its top window (not a
// field element), both over all n scalars as signed_digits reads them.
//
// What bounds it: bytes, 32 B read and 32 B written a scalar (at n = 2^20
// 0.02 ms at 3.35 TB/s); the histogram's shared atomics (one a nonzero
// digit) are the next cost, and a block's flush adds at most 32 x 129
// global atomics.
// ---------------------------------------------------------------------------
constexpr int kWindows = 32;
constexpr int kMags = 129;
constexpr int kDigitThreads = 256;
constexpr long long kDigitTile = 2048;
constexpr int kMetaWords = 9;

__global__ void __launch_bounds__(kDigitThreads)
msm_digits_kernel(const uint32_t* __restrict__ words, long long n,
                  const unsigned char* __restrict__ valid, long long n_ck,
                  long long m, long long tile, signed char* __restrict__ digits,
                  int* __restrict__ counts, int* __restrict__ meta) {
  __shared__ int hist[kWindows * kMags];
  __shared__ uint32_t sor[8];
  __shared__ int scarry;
  const int tid = threadIdx.x;
  for (int k = tid; k < kWindows * kMags; k += blockDim.x) hist[k] = 0;
  if (tid < 8) sor[tid] = 0;
  if (tid == 0) scarry = 0;
  __syncthreads();
  const long long start = (long long)blockIdx.x * tile;
  uint32_t orw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int carry_out = 0;
  for (long long i = start + tid; i < start + tile; i += blockDim.x) {
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    bool keep = false;
    if (i < n) {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = words[i * 8 + k];
      keep = valid == nullptr || valid[i] != 0;
    }
    int carry = 0;
#pragma unroll
    for (int b = 0; b < kWindows; ++b) {
      const int v = (int)((w[b >> 2] >> (8 * (b & 3))) & 0xffu) + carry;
      carry = v >= 128 ? 1 : 0;
      const int d = keep ? v - (carry << 8) : 0;
      digits[(long long)b * n_ck + i] = (signed char)d;
      if (d != 0) atomicAdd(&hist[b * kMags + (d < 0 ? -d : d)], 1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) orw[k] |= w[k];
    carry_out |= carry;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (orw[k]) atomicOr(&sor[k], orw[k]);
  if (carry_out) atomicOr(&scarry, 1);
  __syncthreads();
  int* out = counts + start / m * (kWindows * kMags);
  for (int k = tid; k < kWindows * kMags; k += blockDim.x)
    if (hist[k]) atomicAdd(&out[k], hist[k]);
  if (tid < 8 && sor[tid]) atomicOr((uint32_t*)&meta[tid], sor[tid]);
  if (tid == 0 && scarry) atomicOr(&meta[8], 1);
}

// ---------------------------------------------------------------------------
// The plan, stage B: the insertion schedule (replaces build_schedule, the
// one-hot cumulative sum over (W, 128, m) of every chunk; no TPU kernel:
// tnsh's is XLA).
//
// One block a (chunk, window) walks the chunk's m digits of the window in
// tiles of 256 points.  A point's rank is the number of earlier points of
// the chunk with the same |digit| in the window: inside a warp,
// __match_any_sync on the magnitude gives the lanes that share it and the
// popcount of those below a lane its rank there; the leader of each
// magnitude writes the warp's count to shared memory; threads 0..127, one
// a magnitude, scan those counts over the warps of the tile (exclusive, in
// warp order) starting from their running total, which carries the
// magnitude's count from tile to tile.  So ranks follow point order, as the
// cumulative sum's do, and the schedule is build_schedule's element for
// element: point i of the chunk (digit d, group base and log2 K from the
// plan's (W, 129) maps) goes to row rank >> logk, lane base + (rank &
// (K - 1)) as +(i + 1), or -(i + 1) for d < 0.  Chunk c's rows start at
// row_off[c] of sched (rows x lanes), which the caller zeroed; a block whose
// chunk runs no step, or whose rows would leave sched, returns at once, and
// a rank past the chunk's steps (which the counts rule out) is dropped
// rather than written out of bounds.
//
// What bounds it: bytes, the digits read once (1 B a point and window) and
// the zero-filled schedule written (rows x lanes x 4 B); two block barriers
// a tile.  No (W, 128, m) tensor exists.
// ---------------------------------------------------------------------------
constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;

__global__ void __launch_bounds__(kRankThreads)
msm_rank_kernel(const signed char* __restrict__ digits, long long n_ck,
                long long m, int w_count, const int* __restrict__ base_map,
                const int* __restrict__ logk_map,
                const int* __restrict__ steps,
                const int* __restrict__ row_off, int* __restrict__ sched,
                long long rows, long long lanes) {
  __shared__ int wcnt[kRankWarps * kBuckets];
  __shared__ int woff[kRankWarps * kBuckets];
  const long long chunk = blockIdx.x / w_count;
  const int w = blockIdx.x % w_count;
  // the same for every thread of the block: a chunk with no step, or rows
  // that would leave the schedule's (checked here, as they lie on the card)
  const int own = steps[chunk];
  if (own <= 0 || row_off[chunk] < 0 || row_off[chunk] + own > rows) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int k = tid; k < kRankWarps * kBuckets; k += blockDim.x) wcnt[k] = 0;
  const signed char* dch = digits + (long long)w * n_ck + chunk * m;
  const int* bmap = base_map + w * kMags;
  const int* lmap = logk_map + w * kMags;
  int* out = sched + (long long)row_off[chunk] * lanes;
  const unsigned below_me = (1u << lane) - 1u;
  int total = 0;  // thread b < 128: points of magnitude b + 1 so far
  __syncthreads();
  for (long long t0 = 0; t0 < m; t0 += kRankThreads) {
    const long long i = t0 + tid;
    const int d = dch[i];
    const int mag = d < 0 ? -d : d;
    const unsigned peers = __match_any_sync(0xffffffffu, mag);
    const unsigned below = peers & below_me;
    if (mag != 0 && below == 0) wcnt[warp * kBuckets + mag - 1] = __popc(peers);
    __syncthreads();
    if (tid < kBuckets) {
      int run = total;
      for (int q = 0; q < kRankWarps; ++q) {
        woff[q * kBuckets + tid] = run;
        run += wcnt[q * kBuckets + tid];
        wcnt[q * kBuckets + tid] = 0;
      }
      total = run;
    }
    __syncthreads();
    if (mag != 0) {
      const int rank = woff[warp * kBuckets + mag - 1] + __popc(below);
      const int lk = lmap[mag];
      const int row = rank >> lk;
      if (row < own)
        out[(long long)row * lanes + bmap[mag] + (rank & ((1 << lk) - 1))] =
            d < 0 ? -(int)(i + 1) : (int)(i + 1);
    }
  }
}

}  // namespace

extern "C" {

const char* tnsh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int tnsh_fq_chain(const void* x, const void* y, void* out, long long n,
                  long long batch, long long y_n, int iters, void* stream) {
  return launch_chain<FqField>(x, y, out, n, batch, y_n, iters, stream);
}

int tnsh_g1_padd(const void* x1, const void* y1, const void* z1,
                 const void* x2, const void* y2, const void* z2,
                 const void* mask, void* ox, void* oy, void* oz, long long n,
                 void* stream) {
  if (n > 0) {
    int blocks = 0;
    const cudaError_t err = grid_for(n, kPointThreads, kBlocksPerSm, &blocks);
    if (err != cudaSuccess) return (int)err;
    g1_padd_kernel<<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (const unsigned char*)mask, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, n);
  }
  return (int)cudaGetLastError();
}

int tnsh_msm_insert(const void* sched, long long lanes, int steps,
                    const void* px, const void* py, long long pstride,
                    long long m, const void* inx, const void* iny,
                    const void* inz, void* ox, void* oy, void* oz,
                    void* hazards, void* stream) {
  if (lanes > 0) {
    const int blocks = (int)((lanes + kInsertThreads - 1) / kInsertThreads);
    msm_insert_kernel<<<blocks, kInsertThreads, 0, (cudaStream_t)stream>>>(
        (const int*)sched, lanes, steps, (const uint32_t*)px,
        (const uint32_t*)py, pstride, m, (const uint32_t*)inx,
        (const uint32_t*)iny, (const uint32_t*)inz, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, (int*)hazards);
  }
  return (int)cudaGetLastError();
}

// The threads of msm_insert_kernel that the current device keeps resident
// at once: the widest plan that one launch runs as one wave.
int tnsh_msm_insert_resident_threads(long long* threads) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, msm_insert_kernel, kInsertThreads, 0);
  *threads = err == cudaSuccess ? (long long)blocks * sms * kInsertThreads : 0;
  return (int)err;
}

// One pass (eight levels from t0) of the group fold over lanes / 2^t0
// elements; see msm_fold_tiles_kernel.
int tnsh_msm_fold_tiles(const void* inx, const void* iny, const void* inz,
                        const void* lane_logk, void* ox, void* oy, void* oz,
                        long long lanes, int t0, void* stream) {
  const long long elems = lanes >> t0;
  if (elems > 0) {
    const int blocks = (int)((elems + kTile - 1) / kTile);
    msm_fold_tiles_kernel<<<blocks, kTile, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)inx, (const uint32_t*)iny, (const uint32_t*)inz,
        (const unsigned char*)lane_logk, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, lanes, t0);
  }
  return (int)cudaGetLastError();
}

// Stage A of the plan over n scalars in chunks of m points (n_ck points
// padded, a multiple of m); counts ((n_ck / m) x 32 x 129) and meta (9
// words) zeroed by the caller.
int tnsh_msm_digits(const void* words, long long n, const void* valid,
                    long long n_ck, long long m, void* digits, void* counts,
                    void* meta, void* stream) {
  const long long tile = m < kDigitTile ? m : kDigitTile;
  if (n < 0 || n > n_ck || m < 1 || m & (m - 1) || n_ck % m)
    return (int)cudaErrorInvalidValue;
  if (n_ck > 0) {
    msm_digits_kernel<<<(int)(n_ck / tile), kDigitThreads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)words, n, (const unsigned char*)valid, n_ck, m, tile,
        (signed char*)digits, (int*)counts, (int*)meta);
  }
  return (int)cudaGetLastError();
}

// Stage B of the plan: chunks x w_count blocks; the schedule's rows of
// chunk c start at row_off[c] (steps[c] of them) of the zeroed sched.
int tnsh_msm_rank(const void* digits, long long n_ck, long long m,
                  int w_count, long long chunks, const void* base_map,
                  const void* logk_map, const void* steps,
                  const void* row_off, void* sched, long long rows,
                  long long lanes, void* stream) {
  if (m < kRankThreads || m % kRankThreads || w_count < 1 ||
      w_count > kWindows || chunks * m > n_ck || rows < 0 || lanes < 1)
    return (int)cudaErrorInvalidValue;
  if (chunks > 0) {
    msm_rank_kernel<<<(int)(chunks * w_count), kRankThreads, 0,
                      (cudaStream_t)stream>>>(
        (const signed char*)digits, n_ck, m, w_count, (const int*)base_map,
        (const int*)logk_map, (const int*)steps, (const int*)row_off,
        (int*)sched, rows, lanes);
  }
  return (int)cudaGetLastError();
}

int tnsh_msm_window_sums(const void* x, const void* y, const void* z,
                         long long lanes, const void* canon_src,
                         const void* canon_mask, int w_count,
                         const void* hazards, void* out, void* stream) {
  if (w_count > 0) {
    msm_window_sums_kernel<<<w_count, kBuckets, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, lanes,
        (const int*)canon_src, (const unsigned char*)canon_mask, w_count,
        (const int*)hazards, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
