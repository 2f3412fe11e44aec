// BN254 Fr kernels for Hopper (sm_90a): the sum-check round on the card.
//
// The field arithmetic and the element layout are in field.cuh, shared
// with msm_kernels.cu; a stacked (F, 8, N) tensor puts table f at word
// offset f*8*N.
//
// Three kernels (one with a second, small summing launch) stand in for the
// four Pallas kernels of tnsh/field/fr_pallas.py that the sum-check path
// runs:
//
//   fe_chain_kernel<FrField> <- _chain_call (mont_mul_chain; field.cuh)
//   fr_fold_kernel           <- _fold_call (fold)
//   fr_round_evals_kernel    <- _product_evals_call (product_round_evals)
//   + fr_sum_partials_kernel    and _sop_evals_call
//                               (sum_of_products_round_evals)
//
// Two more build the PST openings' tables from the committed columns on the
// card, where the JAX package computes them on the host:
//
//   fr_rlc_kernel         the gamma-RLC table of F stacked columns (rlc)
//   fr_open_level_kernel  one level of an opening: the fold and the
//                         canonical quotient words (open_level)
//
// and three passes build TwistBits' j-phase Val table from the write
// columns on the card, where the JAX package walks the write cycles on the
// host (prefix_scan):
//
//   fr_scan_blocks_kernel + fr_scan_totals_kernel + fr_scan_add_kernel
//
// Every entry point is a plain C function (bound with ctypes), launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().
//
// What bounds them on the H100: the 256-bit Montgomery multiply (field.cuh:
// PTX carry chains, 264 multiply-add instructions a product, all in
// registers).  The round-evaluation kernel runs a factored program of
// products per lane pair and point and reads each table once per pair and
// run of points, so it is bound by integer multiply throughput, not by
// memory.  Fold does one multiply per output lane and is bound by the bytes
// it moves.  Tensor cores, wgmma and TMA do not apply: there is no exact
// 256-bit integer product on them, and every table element is read once,
// coalesced, by the thread that uses it.

#include "field.cuh"

namespace {

using namespace tnsh;

struct Fr8 {
  uint32_t v[L];
};

// Fr's names for the shared field arithmetic.
#define fr_load fe_load
#define fr_store fe_store
#define fr_zero fe_zero
#define fr_copy fe_copy
#define fr_add fe_add<FrField>
#define fr_sub fe_sub<FrField>
#define fr_mul fe_mul<FrField>

// r = lo + x * d for a small non-negative x, by double-and-add (adds only).
__device__ __forceinline__ void fr_lo_plus_xd(uint32_t r[L],
                                              const uint32_t lo[L],
                                              const uint32_t d[L], int x) {
  uint32_t dd[L];
  fr_copy(r, lo);
  fr_copy(dd, d);
  while (x) {
    if (x & 1) fr_add(r, r, dd);
    x >>= 1;
    if (x) fr_add(dd, dd, dd);
  }
}

// Field sum of one element per thread, in shared memory (limb-major, so
// consecutive threads hit consecutive banks).  blockDim.x is a power of
// two; the total lands in thread 0's return value.
__device__ void fr_block_sum(uint32_t acc[L], uint32_t* sh) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
#pragma unroll
  for (int k = 0; k < L; ++k) sh[k * nt + tid] = acc[k];
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (tid < s) {
      uint32_t a[L], b[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        a[k] = sh[k * nt + tid];
        b[k] = sh[k * nt + tid + s];
      }
      fr_add(a, a, b);
#pragma unroll
      for (int k = 0; k < L; ++k) sh[k * nt + tid] = a[k];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = sh[k * nt];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// fold (replaces fr_pallas._fold_call): bind variable 0 of F stacked tables
// in one launch, out[f][i] = lo + r * (hi - lo) with lo/hi the even/odd
// lanes.  The TPU de-interleaves lo/hi in a separate XLA pass and takes r
// pre-broadcast to a block (a Mosaic workaround); here each thread reads
// its pair strided in place and r arrives by value.  Every power-of-two
// N down to 2 goes through this kernel.
// ---------------------------------------------------------------------------
__global__ void fr_fold_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, Fr8 r,
                               long long num_tables, long long half) {
  const long long n = 2 * half;
  const long long total = num_tables * half;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x) {
    const long long f = g / half;
    const long long i = g - f * half;
    const uint32_t* src = in + f * L * n + 2 * i;
    uint32_t lo[L], hi[L], d[L];
    fr_load(lo, src, n);
    fr_load(hi, src + 1, n);
    fr_sub(d, hi, lo);
    fr_mul(d, r.v, d);
    fr_add(lo, lo, d);
    fr_store(out + f * L * half + i, half, lo);
  }
}

// a <- a - p if a >= p: canonical form of a value in [0, 2p).
__device__ __forceinline__ void fr_reduce_p(uint32_t a[L]) {
  uint32_t d[L];
  d[0] = ptx::sub_cc(a[0], FrField::p(0));
#pragma unroll
  for (int k = 1; k < L; ++k) d[k] = ptx::subc_cc(a[k], FrField::p(k));
  const uint32_t borrow = ptx::subc(0, 0);  // all ones when a < p
#pragma unroll
  for (int k = 0; k < L; ++k) a[k] = borrow ? a[k] : d[k];
}

// ---------------------------------------------------------------------------
// gamma-RLC of F stacked tables (the batched PST opening's table):
// out[i] = sum_f c_f * t_f[i], the coefficients (F, 8) row-major in
// Montgomery form.  A thread owns a lane and walks the tables, so each table
// is read once, coalesced, and the lane's sum stays in registers; every
// thread reads the same coefficient, which the cache broadcasts.
// ---------------------------------------------------------------------------
__global__ void fr_rlc_kernel(const uint32_t* __restrict__ tabs,
                              const uint32_t* __restrict__ coeffs,
                              uint32_t* __restrict__ out,
                              long long num_tables, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t acc[L], v[L], c[L];
    fr_zero(acc);
    for (long long f = 0; f < num_tables; ++f) {
      fr_load(v, tabs + f * L * n + i, n);
      fr_load(c, coeffs + f * L, 1);
      fr_mul(v, c, v);
      fr_add(acc, acc, v);
    }
    fr_store(out + i, n, acc);
  }
}

// ---------------------------------------------------------------------------
// One level of a PST opening (the host engine's fr_ml_open, a level a
// launch): with lo/hi the even/odd lanes of an (8, 2 half) Montgomery table,
//
//   quot[i] = hi - lo, canonical (a product by 1 leaves Montgomery form,
//             one subtraction of p makes it canonical), written row-major as
//             the 32-byte little-endian word the MSM takes;
//   out[i]  = lo + r (hi - lo), the next level's table.
//
// The fold of the sum-check (fr_fold_kernel) stays a kernel of its own.
// ---------------------------------------------------------------------------
__global__ void fr_open_level_kernel(const uint32_t* __restrict__ in,
                                     uint32_t* __restrict__ out,
                                     uint32_t* __restrict__ quot, Fr8 r,
                                     long long half) {
  const long long n = 2 * half;
  uint32_t one[L];
  fr_zero(one);
  one[0] = 1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < half; i += (long long)gridDim.x * blockDim.x) {
    uint32_t lo[L], hi[L], d[L], q[L];
    fr_load(lo, in + 2 * i, n);
    fr_load(hi, in + 2 * i + 1, n);
    fr_sub(d, hi, lo);
    fr_mul(q, d, one);
    fr_reduce_p(q);
    fr_store(quot + i * L, 1, q);
    fr_mul(d, r.v, d);
    fr_add(lo, lo, d);
    fr_store(out + i, half, lo);
  }
}

// ---------------------------------------------------------------------------
// Exclusive prefix sum over Fr (prefix_scan): out[j] = sum_{j' < j} w(j'),
// of TwistBits' write weight
//
//   w(j) = ot(j) * ic(j) * eq(r_k, wa(j)),
//
// formed in the first pass from the write flag, ic and one entry of the
// K-entry table eq(r_k, .) = prod_m chi(r_m, bit m of .) (Montgomery limb
// planes, read through the cache; K a power of two, the address taken mod
// K).  This gives V~(r_k, j), the j-phase table of the virtual Val.  A plain
// scan of a table is the case K = 1 (the table holds one), every flag set.
// It replaces no TPU kernel: tnsh walks the write cycles on the host
// (Python ints, or its native engine's loop).
//
// Three launches, each a stream-ordered pass:
//   fr_scan_blocks_kernel  a block scans kScanLanes lanes: each thread sums
//                          its kScanItems consecutive lanes in registers,
//                          a warp scans its threads' sums by shuffles (one a
//                          limb), warp 0 the block's warp totals through
//                          shared memory; the block writes its lanes'
//                          exclusive sums and its total;
//   fr_scan_totals_kernel  one block scans the block totals (exclusive, in
//                          place), a block's worth at a time with a carry;
//   fr_scan_add_kernel     every lane past the first block adds its
//                          block's offset.
// With one block (n <= kScanLanes) the first launch is the whole scan.
//
// Bound on the H100 at 2^20 lanes, a third of them written, K = 2^10: the
// bytes, about 47.7 MiB (the written lanes' ic 10.7 MiB, the addresses
// 4 MiB, the flags 1 MiB and the 32 KiB table read; V 32 MiB written),
// 0.0149 ms at 3.35 TB/s (0.0216 ms with every lane written).  The
// products, one a written lane, take 0.0057 ms of the card's multiply
// rate, so the bytes bound it.  The offsets' pass reads and writes V once
// more, which the bound does not count.  Inputs may be anywhere in
// [0, 2p); field adds keep the sums there.
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanLanes = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;

// Inclusive scan of one value a thread over its warp, limb by limb.
__device__ __forceinline__ void fr_warp_scan(uint32_t s[L]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t y[L];
#pragma unroll
    for (int k = 0; k < L; ++k) y[k] = __shfl_up_sync(0xffffffffu, s[k], d);
    if (lane >= d) fr_add(s, s, y);
  }
}

// Exclusive scan of x over a block of kScanThreads threads: excl is the
// sum of the lower threads' values, total the block's.  sh holds a value a
// warp (limb-major).  Every thread of the block calls it.
__device__ void fr_block_scan(const uint32_t x[L], uint32_t excl[L],
                              uint32_t total[L], uint32_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc[L];
  fr_copy(inc, x);
  fr_warp_scan(inc);
  if (lane == 31) fr_store(sh + warp, kScanWarps, inc);
  __syncthreads();
  if (warp == 0) {
    uint32_t t[L];
    if (lane < kScanWarps) fr_load(t, sh + lane, kScanWarps);
    else fr_zero(t);
    fr_warp_scan(t);
    if (lane < kScanWarps) fr_store(sh + lane, kScanWarps, t);
  }
  __syncthreads();
  // the lane below's inclusive sum, and the warps' below
#pragma unroll
  for (int k = 0; k < L; ++k) excl[k] = __shfl_up_sync(0xffffffffu, inc[k], 1);
  if (lane == 0) fr_zero(excl);
  if (warp > 0) {
    uint32_t w[L];
    fr_load(w, sh + warp - 1, kScanWarps);
    fr_add(excl, excl, w);
  }
  fr_load(total, sh + kScanWarps - 1, kScanWarps);
  __syncthreads();  // sh is free again
}

__global__ void __launch_bounds__(kScanThreads)
fr_scan_blocks_kernel(const uint32_t* __restrict__ values,
                      const int* __restrict__ addr,
                      const uint8_t* __restrict__ flags,
                      const uint32_t* __restrict__ table, long long k,
                      uint32_t* __restrict__ out,
                      uint32_t* __restrict__ totals, long long n) {
  __shared__ uint32_t sh[kScanWarps * L];
  const long long base =
      (long long)blockIdx.x * kScanLanes + (long long)threadIdx.x * kScanItems;
  uint32_t w[kScanItems][L], sum[L];
  fr_zero(sum);
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    const long long i = base + q;
    fr_zero(w[q]);
    if (i < n && flags[i]) {
      uint32_t e[L];
      fr_load(w[q], values + i, n);
      fr_load(e, table + (addr[i] & (k - 1)), k);
      fr_mul(w[q], w[q], e);
    }
    fr_add(sum, sum, w[q]);
  }
  uint32_t prefix[L], total[L];
  fr_block_scan(sum, prefix, total, sh);
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    const long long i = base + q;
    if (i < n) fr_store(out + i, n, prefix);
    fr_add(prefix, prefix, w[q]);
  }
  if (threadIdx.x == 0) fr_store(totals + (long long)blockIdx.x * L, 1, total);
}

// totals (nblk, 8) -> their exclusive prefix sums, in place; one block.
__global__ void __launch_bounds__(kScanThreads)
fr_scan_totals_kernel(uint32_t* __restrict__ totals, long long nblk) {
  __shared__ uint32_t sh[kScanWarps * L];
  uint32_t carry[L];
  fr_zero(carry);
  for (long long c = 0; c < nblk; c += kScanThreads) {
    const long long i = c + threadIdx.x;
    uint32_t x[L], excl[L], total[L];
    if (i < nblk) fr_load(x, totals + i * L, 1);
    else fr_zero(x);
    fr_block_scan(x, excl, total, sh);
    fr_add(excl, excl, carry);
    if (i < nblk) fr_store(totals + i * L, 1, excl);
    fr_add(carry, carry, total);
  }
}

// out[i] += offsets[i / kScanLanes] for every lane past the first block.
__global__ void fr_scan_add_kernel(uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ offsets,
                                   long long n) {
  for (long long i = kScanLanes + blockIdx.x * (long long)blockDim.x +
                     threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    uint32_t v[L], o[L];
    fr_load(v, out + i, n);
    fr_load(o, offsets + (i / kScanLanes) * L, 1);
    fr_add(v, v, o);
    fr_store(out + i, n, v);
  }
}

// ---------------------------------------------------------------------------
// Round evaluations (replaces fr_pallas._product_evals_call and
// _sop_evals_call):
//
//   g(x) = sum_pairs sum_t c_t * prod_{f in term t} (lo_f + x (hi_f - lo_f))
//
// for x = 0 .. npts-1.  The product-of-MLEs round is the one-term case.
//
// The sum of products arrives as a straight-line program that the host
// builds once an oracle from a prefix trie of the terms
// (tnsh_torch/field/fr_kernels.py `terms`): a factor that several terms
// share is multiplied once, v_f * (c + sum of the subtrees below it).  An
// instruction is op + 8 * arg and works on `cur`, one value a point, and a
// stack of sums S whose slot 0 is the thread's total over its pairs:
//
//   LOADC c   cur = coefficient c          ADDC c   cur += coefficient c
//   MUL f     cur *= table f's values      PUSH     S[sp++] = cur
//   ACC       S[sp-1] += cur               POPADD   cur += S[--sp]
//
// Only MUL multiplies: the program's MULs are the products a pair and
// point (72 on the TwistBits j phase, whose terms hold 159 factors).
//
// A thread owns a lane pair and a run of `run` consecutive points
// x0 .. x0+run-1; the runs are the grid's y axis.  For a MUL it loads the
// table's lo and hi once (one 8-byte load a limb, coalesced), forms
// d = hi - lo and the run's first value lo + x0 d (double-and-add, once a
// run), and steps v += d from point to point: one add a point.
// cur and S live in shared memory, limb-major over the block's threads
// (conflict-free), so the point loop is rolled, the product is inlined
// once, and the run's length is bounded by shared memory and not by the
// register file: (1 + stack slots) * run * 32 bytes a thread.  The host picks
// the run: as long as kMaxRun allows for large rounds, shorter when there
// are few lane pairs, so that a small round still spreads its points over
// the SMs instead of walking them in one thread.
//
// CUDA blocks run in parallel and a 256-bit modular add has no atomic form:
// a block tree-sums S[0] over its threads and writes partials[block][x],
// and a second launch (fr_sum_partials_kernel) sums the blocks.  Where one
// block a run holds every pair, the block writes `out` itself and there is
// no second launch.  Field sums are exact in any order, so results equal
// the plain version's after canonicalization.
// ---------------------------------------------------------------------------
enum RoundOp : int {
  kOpLoadC = 0,
  kOpAddC = 1,
  kOpMul = 2,
  kOpPush = 3,
  kOpAcc = 4,
  kOpPopAdd = 5,
};

constexpr int kEvalThreads = 128;
// The longest run: with the two stack slots of the TwistBits j phase a run
// of 4 takes 48 KB a block, so four blocks (16 warps) stay on an SM and the
// launch needs no opt-in to large shared memory.  On an H100 at 49 tables x
// 2^16 lanes, npts 14, runs of 3 and 4 measured alike and best; 7 (two
// blocks an SM) 10% slower, 1 (a table load and x0 * d for every product)
// 19% slower.
constexpr int kMaxRun = 4;
// bytes of shared memory one slot of one point takes in a block
constexpr int kSlotBytes = kEvalThreads * L * (int)sizeof(uint32_t);
constexpr int kMaxEvalShared = 227 * 1024;

// Slot `slot`, point p of this thread: limb k at [k * kEvalThreads].
__device__ __forceinline__ uint32_t* eval_slot(uint32_t* sh, int run,
                                               int slot, int p) {
  return sh + ((slot * run + p) * L) * kEvalThreads + threadIdx.x;
}

// lo (even lane) and hi (odd lane) of pair i of stacked table f (n lanes a
// table): one 8-byte load a limb, a warp's loads of a limb contiguous.
__device__ __forceinline__ void load_pair(uint32_t lo[L], uint32_t hi[L],
                                          const uint32_t* __restrict__ tabs,
                                          int f, long long n, long long i) {
  const uint32_t* src = tabs + (long long)f * L * n + 2 * i;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint2 w = *reinterpret_cast<const uint2*>(src + k * n);
    lo[k] = w.x;
    hi[k] = w.y;
  }
}

__global__ void __launch_bounds__(kEvalThreads)
fr_round_evals_kernel(const uint32_t* __restrict__ tabs, long long half,
                      const int* __restrict__ prog, int nprog,
                      const uint32_t* __restrict__ coeffs, int nterms,
                      int npts, int run, uint32_t* __restrict__ partials,
                      uint32_t* __restrict__ out) {
  extern __shared__ uint32_t sh[];
  const long long n = 2 * half;
  const int x0 = blockIdx.y * run;
  const int np = npts - x0 < run ? npts - x0 : run;
  // slot 0 is cur, slot 1 + s is S[s]
  {
    uint32_t zero[L];
    fr_zero(zero);
    for (int p = 0; p < np; ++p)
      fr_store(eval_slot(sh, run, 1, p), kEvalThreads, zero);
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < half; i += (long long)gridDim.x * blockDim.x) {
    int sp = 1;
    for (int q = 0; q < nprog; ++q) {
      const int ins = prog[q];
      const int op = ins & 7, arg = ins >> 3;
      if (op == kOpMul) {
        uint32_t v[L], d[L];
        load_pair(v, d, tabs, arg, n, i);
        fr_sub(d, d, v);
        if (x0 != 0) fr_lo_plus_xd(v, v, d, x0);
#pragma unroll 1
        for (int p = 0; p < np; ++p) {
          uint32_t c[L];
          fr_load(c, eval_slot(sh, run, 0, p), kEvalThreads);
          fr_mul(c, c, v);
          fr_store(eval_slot(sh, run, 0, p), kEvalThreads, c);
          if (p + 1 < np) fr_add(v, v, d);
        }
      } else if (op == kOpLoadC || op == kOpAddC) {
        uint32_t c[L];
        fr_load(c, coeffs + arg, nterms);
        for (int p = 0; p < np; ++p) {
          uint32_t* cur = eval_slot(sh, run, 0, p);
          if (op == kOpAddC) {
            uint32_t t[L];
            fr_load(t, cur, kEvalThreads);
            fr_add(t, t, c);
            fr_store(cur, kEvalThreads, t);
          } else {
            fr_store(cur, kEvalThreads, c);
          }
        }
      } else {
        // PUSH copies cur up; ACC and POPADD add cur and the top slot
        if (op == kOpPopAdd) --sp;
        const int top = op == kOpPush ? sp : sp - (op == kOpAcc ? 1 : 0);
        for (int p = 0; p < np; ++p) {
          uint32_t* cur = eval_slot(sh, run, 0, p);
          uint32_t* st = eval_slot(sh, run, 1 + top, p);
          uint32_t a[L];
          fr_load(a, cur, kEvalThreads);
          if (op == kOpPush) {
            fr_store(st, kEvalThreads, a);
          } else {
            uint32_t b[L];
            fr_load(b, st, kEvalThreads);
            fr_add(a, a, b);
            fr_store(op == kOpAcc ? st : cur, kEvalThreads, a);
          }
        }
        if (op == kOpPush) ++sp;
      }
    }
  }
  // tree-sum S[0] over the block's threads, every point of the run a level
  const int tid = threadIdx.x;
  for (int s = kEvalThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (tid < s) {
      for (int p = 0; p < np; ++p) {
        uint32_t* mine = eval_slot(sh, run, 1, p);
        uint32_t a[L], b[L];
        fr_load(a, mine, kEvalThreads);
        fr_load(b, mine + s, kEvalThreads);
        fr_add(a, a, b);
        fr_store(mine, kEvalThreads, a);
      }
    }
  }
  __syncthreads();
  if (tid < np) {
    uint32_t a[L];
    fr_load(a, sh + ((run + tid) * L) * kEvalThreads, kEvalThreads);
    if (gridDim.x == 1) {
      fr_store(out + x0 + tid, npts, a);
    } else {
      fr_store(partials + ((long long)blockIdx.x * npts + x0 + tid) * L, 1, a);
    }
  }
}

// Sum the per-block partials (nblk, npts, 8) into out (8, npts); one block
// per evaluation point.
__global__ void fr_sum_partials_kernel(const uint32_t* __restrict__ partials,
                                       int nblk, int npts,
                                       uint32_t* __restrict__ out) {
  extern __shared__ uint32_t sh[];
  const int x = blockIdx.x;
  uint32_t acc[L];
  fr_zero(acc);
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) {
    uint32_t v[L];
    fr_load(v, partials + ((long long)b * npts + x) * L, 1);
    fr_add(acc, acc, v);
  }
  fr_block_sum(acc, sh);
  if (threadIdx.x == 0) fr_store(out + x, npts, acc);
}

// The run of points a thread takes: kMaxRun for a round with blocks enough
// to fill the card's `sms` SMs, shorter when `nblk` blocks a run would leave
// SMs idle, and never more than `slots` slots of shared memory allow.
int pick_run(int nblk, int npts, int slots, int sms) {
  int cap = kMaxRun;
  const int fits = kMaxEvalShared / (slots * kSlotBytes);
  if (cap > fits) cap = fits;
  if (cap < 1) return 0;
  int runs = (npts + cap - 1) / cap;
  const int wanted = (sms + nblk - 1) / nblk;
  if (runs < wanted) runs = wanted;
  if (runs > npts) runs = npts;
  return (npts + runs - 1) / runs;
}

}  // namespace

extern "C" {

const char* tnsh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int tnsh_fr_chain(const void* x, const void* y, void* out, long long n,
                  long long batch, long long y_n, int iters, void* stream) {
  return launch_chain<FrField>(x, y, out, n, batch, y_n, iters, stream);
}

int tnsh_fr_fold(const void* in, void* out, const void* r_host,
                 long long num_tables, long long half, void* stream) {
  Fr8 r;
  const uint32_t* rw = (const uint32_t*)r_host;
  for (int k = 0; k < L; ++k) r.v[k] = rw[k];
  const long long total = num_tables * half;
  if (total > 0) {
    int blocks = 0;
    const cudaError_t err = grid_for(total, kThreads, kBlocksPerSm, &blocks);
    if (err != cudaSuccess) return (int)err;
    fr_fold_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, r, num_tables, half);
  }
  return (int)cudaGetLastError();
}

int tnsh_fr_rlc(const void* tabs, const void* coeffs, void* out,
                long long num_tables, long long n, void* stream) {
  if (n > 0) {
    int blocks = 0;
    const cudaError_t err = grid_for(n, kThreads, kBlocksPerSm, &blocks);
    if (err != cudaSuccess) return (int)err;
    fr_rlc_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)tabs, (const uint32_t*)coeffs, (uint32_t*)out,
        num_tables, n);
  }
  return (int)cudaGetLastError();
}

// quot: the level's half words, 8 uint32 each (row-major)
int tnsh_fr_open_level(const void* in, void* out, void* quot,
                       const void* r_host, long long half, void* stream) {
  Fr8 r;
  const uint32_t* rw = (const uint32_t*)r_host;
  for (int k = 0; k < L; ++k) r.v[k] = rw[k];
  if (half > 0) {
    int blocks = 0;
    const cudaError_t err = grid_for(half, kThreads, kBlocksPerSm, &blocks);
    if (err != cudaSuccess) return (int)err;
    fr_open_level_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, (uint32_t*)quot, r, half);
  }
  return (int)cudaGetLastError();
}

// Blocks of the scan's first pass, and so rows (of 8 words) of `totals`.
int tnsh_fr_prefix_scan_blocks(long long n) {
  return (int)((n + kScanLanes - 1) / kScanLanes);
}

// out = the exclusive prefix sums of the weights flags[j] * values[j] *
// table[addr[j] mod k]: values and out (8, n) each, addr n int32, flags n
// bytes (0 or 1), table (8, k) Montgomery words with k a power of two.
// totals is tnsh_fr_prefix_scan_blocks(n) x 8 words of scratch.
int tnsh_fr_prefix_scan(const void* values, const void* addr,
                        const void* flags, const void* table, long long k,
                        void* out, void* totals, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (k <= 0 || (k & (k - 1)) != 0) return (int)cudaErrorInvalidValue;
  const long long nblk = (n + kScanLanes - 1) / kScanLanes;
  const cudaStream_t st = (cudaStream_t)stream;
  fr_scan_blocks_kernel<<<(unsigned)nblk, kScanThreads, 0, st>>>(
      (const uint32_t*)values, (const int*)addr, (const uint8_t*)flags,
      (const uint32_t*)table, k, (uint32_t*)out, (uint32_t*)totals, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return (int)err;
  fr_scan_totals_kernel<<<1, kScanThreads, 0, st>>>((uint32_t*)totals, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = grid_for(n - kScanLanes, kThreads, kBlocksPerSm, &blocks);
  if (err != cudaSuccess) return (int)err;
  fr_scan_add_kernel<<<blocks, kThreads, 0, st>>>(
      (uint32_t*)out, (const uint32_t*)totals, n);
  return (int)cudaGetLastError();
}

// Number of blocks along the lane pairs (and so of partial sums a point)
// the round-evaluation launch uses for `half` lane pairs; the caller sizes
// `partials` with it.  One block means one launch: the block writes `out`.
// A failed runtime call comes back as minus its CUDA error code.
constexpr int kEvalBlocksPerSm = 8;

int tnsh_fr_round_evals_blocks(long long half) {
  int blocks = 0;
  const cudaError_t err =
      grid_for(half, kEvalThreads, kEvalBlocksPerSm, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// prog: nprog instructions (op + 8 * arg); depth: the stack slots the
// program needs, slot 0 included.  partials is (nblk, npts, 8) scratch and
// may be null when nblk is 1.
int tnsh_fr_round_evals(const void* tabs, long long half, const void* prog,
                        int nprog, int depth, const void* coeffs, int nterms,
                        int npts, void* partials, int nblk, void* out,
                        void* stream) {
  if (nblk < 1 || (nblk > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int slots = 1 + depth;
  const int run = pick_run(nblk, npts, slots, sms);
  if (run < 1) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)slots * run * kSlotBytes;
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(fr_round_evals_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxEvalShared);
    if (err != cudaSuccess) return (int)err;
  }
  fr_round_evals_kernel<<<dim3(nblk, (npts + run - 1) / run), kEvalThreads,
                          shmem, (cudaStream_t)stream>>>(
      (const uint32_t*)tabs, half, (const int*)prog, nprog,
      (const uint32_t*)coeffs, nterms, npts, run, (uint32_t*)partials,
      (uint32_t*)out);
  err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return (int)err;
  fr_sum_partials_kernel<<<npts, kEvalThreads, kSlotBytes,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)partials, nblk, npts, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
