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
// Every entry point is a plain C function (bound with ctypes), launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().
//
// What bounds them on the H100: the 256-bit Montgomery multiply.  One CIOS
// product is 128 32x32->64-bit multiplies plus carry adds, all in
// registers; the round-evaluation kernel does (terms x factors x points)
// of them per lane pair and reads each table once per point, so it is
// bound by integer multiply throughput, not by memory.  Fold does one
// multiply per output lane and is bound by the bytes it moves.  Tensor
// cores do not apply (no exact 256-bit integer product).  This first
// version is plain C++: carry chains in PTX (add.cc / madc) are later work.

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

// ---------------------------------------------------------------------------
// Round evaluations (replaces fr_pallas._product_evals_call and
// _sop_evals_call):
//
//   g(x) = sum_pairs sum_t c_t * prod_{f in term t} (lo_f + x (hi_f - lo_f))
//
// for x = 0 .. npts-1.  Terms come as CSR (term_off[t] .. term_off[t+1]
// index term_idx), coefficients as an (8, nterms) Montgomery tensor.  The
// product-of-MLEs round is the one-term case.
//
// Two differences from the TPU design:
//  * The TPU sums across grid steps in a revisited output block.  CUDA
//    blocks run in parallel and a 256-bit modular add has no atomic form,
//    so each block tree-sums its threads into partials[block][x] and a
//    second launch (fr_sum_partials_kernel) sums the blocks.
//  * The TPU holds npts values per table in VMEM.  Registers are the
//    scarce resource here (14 points x 8 words x 49 tables does not fit),
//    so x is outermost -- the grid's y axis, one point per block -- each
//    thread keeps one 8-word accumulator and recomputes lo + x*d per
//    factor, which costs adds only.  Putting x on the grid also gives
//    npts times more blocks to fill the 132 SMs.
// Field sums are exact in any order, so results equal the plain version's
// after canonicalization.
// ---------------------------------------------------------------------------
__global__ void fr_round_evals_kernel(const uint32_t* __restrict__ tabs,
                                      long long half,
                                      const int* __restrict__ term_off,
                                      const int* __restrict__ term_idx,
                                      int nterms,
                                      const uint32_t* __restrict__ coeffs,
                                      int npts,
                                      uint32_t* __restrict__ partials) {
  extern __shared__ uint32_t sh[];
  const long long n = 2 * half;
  const int x = blockIdx.y;
  uint32_t acc[L];
  fr_zero(acc);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < half; i += (long long)gridDim.x * blockDim.x) {
    for (int t = 0; t < nterms; ++t) {
      uint32_t prod[L];
      const int beg = term_off[t];
      const int end = term_off[t + 1];
      for (int q = beg; q < end; ++q) {
        const uint32_t* src = tabs + (long long)term_idx[q] * L * n + 2 * i;
        uint32_t v[L];
        if (x == 0) {
          fr_load(v, src, n);
        } else if (x == 1) {
          fr_load(v, src + 1, n);
        } else {
          uint32_t lo[L], hi[L];
          fr_load(lo, src, n);
          fr_load(hi, src + 1, n);
          fr_sub(hi, hi, lo);
          fr_lo_plus_xd(v, lo, hi, x);
        }
        if (q == beg) {
          fr_copy(prod, v);
        } else {
          fr_mul(prod, prod, v);
        }
      }
      uint32_t c[L];
      fr_load(c, coeffs + t, nterms);
      fr_mul(prod, prod, c);
      fr_add(acc, acc, prod);
    }
  }
  fr_block_sum(acc, sh);
  if (threadIdx.x == 0) {
    fr_store(partials + ((long long)blockIdx.x * npts + x) * L, 1, acc);
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

constexpr int kEvalThreads = 128;

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
    fr_fold_kernel<<<grid_for(total, kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)in,
                                             (uint32_t*)out, r, num_tables,
                                             half);
  }
  return (int)cudaGetLastError();
}

// Number of blocks (and so of partial sums) the round-evaluation launch
// uses for `half` lane pairs; the caller sizes `partials` with it.
int tnsh_fr_round_evals_blocks(long long half) {
  long long blocks = (half + kEvalThreads - 1) / kEvalThreads;
  const long long cap = 132LL * 8;
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

int tnsh_fr_round_evals(const void* tabs, long long half,
                        const void* term_off, const void* term_idx,
                        int nterms, const void* coeffs, int npts,
                        void* partials, int nblk, void* out, void* stream) {
  const size_t shmem = (size_t)kEvalThreads * L * sizeof(uint32_t);
  fr_round_evals_kernel<<<dim3(nblk, npts), kEvalThreads, shmem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)tabs, half, (const int*)term_off, (const int*)term_idx,
      nterms, (const uint32_t*)coeffs, npts, (uint32_t*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fr_sum_partials_kernel<<<npts, kEvalThreads, shmem, (cudaStream_t)stream>>>(
      (const uint32_t*)partials, nblk, npts, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
