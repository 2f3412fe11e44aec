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
// and three more run TwistBits' k rounds on the card, where the JAX package
// walks the cycles on the host (twist_k_buckets, twist_k_round,
// twist_k_bind):
//
//   tbk_walk_kernel<true> + tbk_chunk_scan_kernel   the chunk-start buckets
//   tbk_walk_kernel<false> + fr_sum_partials_kernel a round's sums
//   tbk_bind_kernel                                 the running chi products
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

// ---------------------------------------------------------------------------
// TwistBits' k rounds (twist_k_buckets, twist_k_round, twist_k_bind): the
// host engine's tbk_round_evals / tbk_bind on the card.  The JAX package
// has no TPU kernel here: it walks the cycles on the host, in Python ints
// or in that engine's loop.
//
// Round i of log K binds address bit i.  Cycle j has one address, a(j) =
// its read address on a read and its write address on a write, of which
// a = a(j) >> i remains; a running product A(j) = prod_{m < i}
// chi(r_m, bit m of a(j)) (one until the first bind); and the buckets
// B[a'] = sum of ic * A over the writes before j whose remaining address
// is a' (nb = K >> i of them).  With s = a >> 1, b = a & 1,
// vp(X) = (1 - X) B[2s] + X B[2s+1] and E the folded eq(sigma_k, .):
//
//   read:  eq1 * A * chi(X, b) * vp(X)                          X = 0..2
//   write: eqs * A * chi(X, b) * E(s, X) * (ic - wv + vp(X))    X = 0..3
//
// and the write joins B[a] after its own terms.  A round's seven sums are
// the exact values of the read part and the write part on their grids
// (quadratic and cubic in X); the host multiplies the write part by
// alpha, adds the rv lift and extends both to the round's points.  At
// round 0 an eighth sum, of eq1 * rv, gives the lift once for all rounds.
//
// T is cut into chunks of `chunk` cycles, a block of one warp a chunk.
// P[c] holds the buckets at chunk c's start (the writes of every chunk
// before it), so a block loads P[c] into shared memory and walks its chunk
// alone, a warp of cycles a step.  The lanes of a step whose cycles share
// a pair s find each other with __match_any_sync (as msm_rank_kernel
// ranks its digits); a lane adds the weights of the writes among its lower
// peers to the B[2s] and B[2s+1] it reads, and the highest peer writes the
// step's sums back.  Field sums are exact in any order, so the values are
// the sequential walk's.
//
//   tbk_walk_kernel<true>   the chunks' own bucket sums (round 0: A = 1),
//   + tbk_chunk_scan_kernel made exclusive over the chunks in place: P_0;
//   tbk_walk_kernel<false>  a block's sums, which fr_sum_partials_kernel
//                           adds over the blocks;
//   tbk_bind_kernel         A *= chi(r, bit i of a(j)).
//
// P is never rebuilt: bucket s of round i + 1 joins buckets 2s and 2s + 1 of
// round i, and the A of a write in them gains chi(r_i, its bit), so
// P_{i+1}[c][s] = (1 - r_i) P_i[c][2s] + r_i P_i[c][2s+1], one
// fr_fold_kernel launch on the (chunks + 1, 8, nb) stack whose last table
// is E, which folds alike.
//
// Bound on the H100: the products.  A read takes three (eq1 * A, then the
// two of its three points where chi is not 0), a write eight (eqs * A,
// ic * A, and two at each of the three points where chi is not 0); the
// lift one a cycle at round 0, the bind one a cycle.  At T = 2^20 with a
// third of the cycles writing that is about 4.9 M products a round, 0.058
// ms at the card's multiply rate; the bytes (the five tables and A, 192
// MiB at round 0) take 0.060 ms, so a round is bound near 0.06 ms and the
// ten about 0.6 ms.  The walk runs a warp a block, its steps one after
// another, so the latency of the products, not their count, sets its time.
// ---------------------------------------------------------------------------
constexpr int kWalkThreads = 32;
// the sums a round block writes: the read part at X = 0..2, the write part
// at X = 0..3, and at round 0 eq1 * rv
constexpr int kWalkSums = 8;
constexpr int kMaxWalkShared = 227 * 1024;

// Shared memory of a walk block over nb buckets, in bytes: the buckets, a
// step's write weights and codes, and the block sums' scratch.
inline size_t walk_shared_bytes(long long nb) {
  return (size_t)(L * nb + 2 * L * kWalkThreads + kWalkThreads) *
         sizeof(uint32_t);
}

// r = k * a for a small k > 0, by adds.
__device__ __forceinline__ void fr_small_mul(uint32_t r[L],
                                             const uint32_t a[L], int k) {
  uint32_t acc[L];
  fr_copy(acc, a);
  for (int q = 1; q < k; ++q) fr_add(acc, acc, a);
  fr_copy(r, acc);
}

// s += k * v for k in {-2, -1, 1, 2, 3} (chi at a point where it is not 0).
__device__ __forceinline__ void fr_add_chi(uint32_t s[L], const uint32_t v[L],
                                           int k) {
  uint32_t t[L];
  fr_small_mul(t, v, k < 0 ? -k : k);
  if (k < 0) fr_sub(s, s, t);
  else fr_add(s, s, t);
}

template <bool kTotals>
__global__ void __launch_bounds__(kWalkThreads)
tbk_walk_kernel(const int* __restrict__ ra, const int* __restrict__ wa,
                const uint8_t* __restrict__ ot,
                const uint32_t* __restrict__ amul,
                const uint32_t* __restrict__ eq1,
                const uint32_t* __restrict__ eqs,
                const uint32_t* __restrict__ ic,
                const uint32_t* __restrict__ wv,
                const uint32_t* __restrict__ rv,
                const uint32_t* __restrict__ buckets,
                uint32_t* __restrict__ out, long long t, long long chunk,
                int shift, long long nb) {
  extern __shared__ uint32_t sh[];
  uint32_t* bk = sh;                          // L x nb, limb-major
  uint32_t* wsh = bk + L * nb;                // L x 32: a step's weights
  uint32_t* red = wsh + L * kWalkThreads;     // L x 32: the block sums
  int* code = (int*)(red + L * kWalkThreads); // 32: 0 read, 1 + bit write
  const int lane = threadIdx.x;
  const long long c = blockIdx.x;
  const long long chunks = gridDim.x;
  for (long long q = lane; q < nb; q += kWalkThreads) {
#pragma unroll
    for (int k = 0; k < L; ++k)
      bk[k * nb + q] = kTotals ? 0u : buckets[(c * L + k) * nb + q];
  }
  // E, eq(sigma_k, .) folded over the bound bits: the stack's last table
  const uint32_t* e = kTotals ? nullptr : buckets + chunks * L * nb;
  uint32_t sums[kWalkSums][L];
#pragma unroll
  for (int q = 0; q < kWalkSums; ++q) fr_zero(sums[q]);
  const unsigned below_me = (1u << lane) - 1u;
  const long long j_lo = c * chunk;
  const long long j_hi = j_lo + chunk < t ? j_lo + chunk : t;
  __syncthreads();
  for (long long j0 = j_lo; j0 < j_hi; j0 += kWalkThreads) {
    const long long j = j0 + lane;
    const bool live = j < j_hi;
    const bool w = live && ot[j];
    const int a = live ? (w ? wa[j] : ra[j]) >> shift : 0;
    const int s = live ? a >> 1 : -1;
    const int b = a & 1;
    uint32_t am[L], wgt[L];
    fr_zero(am);
    if (live && amul) fr_load(am, amul + j, t);
    fr_zero(wgt);
    if (w) {
      fr_load(wgt, ic + j, t);
      if (amul) fr_mul(wgt, wgt, am);
    }
    fr_store(wsh + lane, kWalkThreads, wgt);
    code[lane] = w ? 1 + b : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    __syncthreads();
    // the weights of the writes among the lower peers, by their bit
    uint32_t b0[L], b1[L];
    fr_zero(b0);
    fr_zero(b1);
    const unsigned lower = peers & below_me;
    for (int l = 0; l < lane; ++l) {
      if (!((lower >> l) & 1u) || code[l] == 0) continue;
      uint32_t v[L];
      fr_load(v, wsh + l, kWalkThreads);
      if (code[l] == 1) fr_add(b0, b0, v);
      else fr_add(b1, b1, v);
    }
    if (live) {
      uint32_t v[L];
      fr_load(v, bk + 2 * s, nb);
      fr_add(b0, b0, v);
      fr_load(v, bk + 2 * s + 1, nb);
      fr_add(b1, b1, v);
    }
    __syncthreads();  // every lane has read its buckets
    if (live && (peers >> lane) == 1u) {
      // the highest peer: the pair's buckets after the step
      uint32_t n0[L], n1[L];
      fr_copy(n0, b0);
      fr_copy(n1, b1);
      if (w && b) fr_add(n1, n1, wgt);
      else if (w) fr_add(n0, n0, wgt);
      fr_store(bk + 2 * s, nb, n0);
      fr_store(bk + 2 * s + 1, nb, n1);
    }
    if (!kTotals && live) {
      if (rv) {
        uint32_t x[L], y[L];
        fr_load(x, eq1 + j, t);
        fr_load(y, rv + j, t);
        fr_mul(x, x, y);
        fr_add(sums[7], sums[7], x);
      }
      uint32_t d[L];
      fr_sub(d, b1, b0);
      if (!w) {
        // chi(X, 0) = 1, 0, -1 and chi(X, 1) = 0, 1, 2 at X = 0, 1, 2
        uint32_t wr[L], m[L], v2[L];
        fr_load(wr, eq1 + j, t);
        if (amul) fr_mul(wr, wr, am);
#pragma unroll
        for (int k = 0; k < L; ++k) v2[k] = b ? b1[k] : b0[k];
        fr_mul(m, wr, v2);
        if (b) fr_add(sums[1], sums[1], m);
        else fr_add(sums[0], sums[0], m);
        fr_add(v2, b1, d);
        fr_mul(m, wr, v2);
        fr_add_chi(sums[2], m, b ? 2 : -1);
      } else {
        // chi(X, 0) = 1, 0, -1, -2 and chi(X, 1) = 0, 1, 2, 3 at X = 0..3
        uint32_t base[L], e0[L], ed[L], v[L], m[L];
        fr_load(base, eqs + j, t);
        if (amul) fr_mul(base, base, am);
        fr_load(e0, e + 2 * s, nb);
        fr_load(ed, e + 2 * s + 1, nb);
        fr_sub(ed, ed, e0);
        fr_load(v, ic + j, t);
        fr_load(m, wv + j, t);
        fr_sub(v, v, m);       // ic - wv
        fr_add(v, v, b0);      // ... + vp(0)
        if (b) {
          fr_add(e0, e0, ed);  // E(s, 1)
          fr_add(v, v, d);     // ... + vp(1)
        }
        fr_mul(m, base, e0);
        fr_mul(m, m, v);
        if (b) fr_add(sums[4], sums[4], m);
        else fr_add(sums[3], sums[3], m);
        if (!b) {
          fr_add(e0, e0, ed);
          fr_add(v, v, d);
        }
        // X = 2, then 3
#pragma unroll
        for (int x = 2; x < 4; ++x) {
          fr_add(e0, e0, ed);
          fr_add(v, v, d);
          fr_mul(m, base, e0);
          fr_mul(m, m, v);
          fr_add_chi(sums[3 + x], m, b ? x : 1 - x);
        }
      }
    }
  }
  __syncthreads();
  if (kTotals) {
    for (long long q = lane; q < nb; q += kWalkThreads) {
#pragma unroll
      for (int k = 0; k < L; ++k) out[(c * L + k) * nb + q] = bk[k * nb + q];
    }
    return;
  }
  const int nsums = rv ? kWalkSums : kWalkSums - 1;
#pragma unroll
  for (int q = 0; q < kWalkSums; ++q) {
    if (q >= nsums) break;
    fr_block_sum(sums[q], red);
    if (lane == 0) fr_store(out + (c * nsums + q) * L, 1, sums[q]);
  }
}

// The chunks' bucket sums (chunks, 8, nb) -> their exclusive prefix sums
// over the chunks, in place: a thread a bucket, which loads the next
// chunk's sums before it stores this one's.
__global__ void tbk_chunk_scan_kernel(uint32_t* __restrict__ p,
                                      long long chunks, long long nb) {
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < nb; q += (long long)gridDim.x * blockDim.x) {
    uint32_t run[L], cur[L];
    fr_zero(run);
    fr_load(cur, p + q, nb);
    for (long long c = 0; c < chunks; ++c) {
      uint32_t nxt[L];
      if (c + 1 < chunks) fr_load(nxt, p + (c + 1) * L * nb + q, nb);
      fr_store(p + c * L * nb + q, nb, run);
      fr_add(run, run, cur);
      fr_copy(cur, nxt);
    }
  }
}

// A *= chi(r, bit `shift` of a(j)), a(j) the cycle's read or write address;
// a null `in` stands for A = 1.  `om` is 1 - r.
__global__ void tbk_bind_kernel(const int* __restrict__ ra,
                                const int* __restrict__ wa,
                                const uint8_t* __restrict__ ot,
                                const uint32_t* in, uint32_t* out, Fr8 r,
                                Fr8 om, long long t, int shift) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < t;
       j += (long long)gridDim.x * blockDim.x) {
    const int a = ot[j] ? wa[j] : ra[j];
    const uint32_t* c = ((a >> shift) & 1) ? r.v : om.v;
    uint32_t v[L];
    if (in) {
      fr_load(v, in + j, t);
      fr_mul(v, v, c);
    } else {
      fr_copy(v, c);
    }
    fr_store(out + j, t, v);
  }
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

// TwistBits' k round `shift` over t cycles in chunks of `chunk`
// (chunks = ceil(t / chunk) of them): ra, wa t int32 addresses, ot t bytes
// (0 or 1), amul the running products A (8, t), null while A = 1, and the
// (8, t) tables below, every one Montgomery words.  The buckets' stack is
// (chunks + 1, 8, nb): a row a chunk, then E.

// Writes rows 0 .. chunks - 1 of `buckets`: the write buckets at each
// chunk's start, sum of ic * A by remaining address; row `chunks` is the
// caller's.
int tnsh_tbk_buckets(const void* ra, const void* wa, const void* ot,
                     const void* amul, const void* ic, void* buckets,
                     long long t, long long chunk, int shift, long long nb,
                     void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  if (chunk <= 0 || nb < 2) return (int)cudaErrorInvalidValue;
  const size_t shmem = walk_shared_bytes(nb);
  if (shmem > (size_t)kMaxWalkShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(tbk_walk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxWalkShared);
    if (err != cudaSuccess) return (int)err;
  }
  const long long chunks = (t + chunk - 1) / chunk;
  const cudaStream_t st = (cudaStream_t)stream;
  tbk_walk_kernel<true><<<(unsigned)chunks, kWalkThreads, shmem, st>>>(
      (const int*)ra, (const int*)wa, (const uint8_t*)ot,
      (const uint32_t*)amul, nullptr, nullptr, (const uint32_t*)ic, nullptr,
      nullptr, nullptr, (uint32_t*)buckets, t, chunk, shift, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = grid_for(nb, kThreads, kBlocksPerSm, &blocks);
  if (err != cudaSuccess) return (int)err;
  tbk_chunk_scan_kernel<<<blocks, kThreads, 0, st>>>((uint32_t*)buckets,
                                                      chunks, nb);
  return (int)cudaGetLastError();
}

// The round's sums into out (8, nsums): the read part at X = 0..2, the
// write part (without alpha) at X = 0..3, and with rv given (round 0) the
// sum of eq1 * rv; nsums = 8 with rv, 7 without.  partials is
// (chunks, nsums, 8) scratch.
int tnsh_tbk_round(const void* ra, const void* wa, const void* ot,
                   const void* amul, const void* eq1, const void* eqs,
                   const void* ic, const void* wv, const void* rv,
                   const void* buckets, void* partials, void* out,
                   long long t, long long chunk, int shift, long long nb,
                   void* stream) {
  if (t <= 0 || chunk <= 0 || nb < 2) return (int)cudaErrorInvalidValue;
  const size_t shmem = walk_shared_bytes(nb);
  if (shmem > (size_t)kMaxWalkShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(tbk_walk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxWalkShared);
    if (err != cudaSuccess) return (int)err;
  }
  const long long chunks = (t + chunk - 1) / chunk;
  const int nsums = rv ? kWalkSums : kWalkSums - 1;
  const cudaStream_t st = (cudaStream_t)stream;
  tbk_walk_kernel<false><<<(unsigned)chunks, kWalkThreads, shmem, st>>>(
      (const int*)ra, (const int*)wa, (const uint8_t*)ot,
      (const uint32_t*)amul, (const uint32_t*)eq1, (const uint32_t*)eqs,
      (const uint32_t*)ic, (const uint32_t*)wv, (const uint32_t*)rv,
      (const uint32_t*)buckets, (uint32_t*)partials, t, chunk, shift, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fr_sum_partials_kernel<<<nsums, kEvalThreads, kSlotBytes, st>>>(
      (const uint32_t*)partials, (int)chunks, nsums, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// out = in * chi(r, bit `shift` of each cycle's address), (8, t); in may be
// null (A = 1) or out.  r and om = 1 - r: 8 Montgomery words each, host.
int tnsh_tbk_bind(const void* ra, const void* wa, const void* ot,
                  const void* in, void* out, const void* r_host,
                  const void* om_host, long long t, int shift, void* stream) {
  Fr8 r, om;
  const uint32_t* rw = (const uint32_t*)r_host;
  const uint32_t* ow = (const uint32_t*)om_host;
  for (int k = 0; k < L; ++k) {
    r.v[k] = rw[k];
    om.v[k] = ow[k];
  }
  if (t > 0) {
    int blocks = 0;
    const cudaError_t err = grid_for(t, kThreads, kBlocksPerSm, &blocks);
    if (err != cudaSuccess) return (int)err;
    tbk_bind_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)ra, (const int*)wa, (const uint8_t*)ot,
        (const uint32_t*)in, (uint32_t*)out, r, om, t, shift);
  }
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
