// Montgomery arithmetic over a 256-bit prime, shared by every kernel file
// of the port (fr_kernels.cu compiles it for BN254's scalar field Fr,
// msm_kernels.cu for the base field Fq).
//
// Layout (tnsh_torch/field/limbs.py): a field element is eight 32-bit
// little-endian limbs in Montgomery form with R = 2^256, lazily reduced
// into [0, 2p).  4p < 2^256 holds for both primes, so CIOS keeps [0, 2p)
// closed and add/sub reduce once against 2p.  Tensors are limb-major: an
// (8, N) table stores limb k of lane i at word k*N + i, so a warp's loads
// of one limb are coalesced.
//
// A field is a struct with `static constexpr uint32_t N0` (-p^{-1} mod
// 2^32) and device accessors `p(k)` / `p2(k)` for the limbs of p and 2p
// (read from __constant__ memory); every function here takes it as its
// template parameter, so both fields run the same code.
//
// The arithmetic is written in PTX carry chains (add.cc / addc, sub.cc /
// subc, mad.lo.cc / madc.hi.cc), one instruction an inline asm statement
// in namespace ptx below; see fe_mul for the product's schedule.

#pragma once

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace tnsh {

constexpr int L = 8;

// BN254 scalar field: p = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001
__constant__ uint32_t kFrP[L] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
__constant__ uint32_t kFrP2[L] = {
    0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
    0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};

// BN254 base field: q = 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47
__constant__ uint32_t kFqP[L] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
__constant__ uint32_t kFqP2[L] = {
    0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
    0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};

struct FrField {
  static constexpr uint32_t N0 = 0xefffffffu;  // -p^{-1} mod 2^32
  __device__ __forceinline__ static uint32_t p(int k) { return kFrP[k]; }
  __device__ __forceinline__ static uint32_t p2(int k) { return kFrP2[k]; }
};

struct FqField {
  static constexpr uint32_t N0 = 0xe4866389u;  // -q^{-1} mod 2^32
  __device__ __forceinline__ static uint32_t p(int k) { return kFqP[k]; }
  __device__ __forceinline__ static uint32_t p2(int k) { return kFqP2[k]; }
};

__device__ __forceinline__ void fe_load(uint32_t r[L], const uint32_t* src,
                                        long long limb_stride) {
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = src[k * limb_stride];
}

__device__ __forceinline__ void fe_store(uint32_t* dst, long long limb_stride,
                                         const uint32_t r[L]) {
#pragma unroll
  for (int k = 0; k < L; ++k) dst[k * limb_stride] = r[k];
}

__device__ __forceinline__ void fe_zero(uint32_t r[L]) {
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = 0;
}

__device__ __forceinline__ void fe_copy(uint32_t r[L], const uint32_t a[L]) {
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = a[k];
}

// ---------------------------------------------------------------------------
// One PTX instruction a function.  The carry flag (CC.CF) lives between
// them: every asm is volatile, so the compiler keeps their order, and
// nothing else it emits touches the flag.  A chain starts with an
// instruction that does not read the flag and ends with one that does not
// write it.
//
// A compiler that is not nvcc (a host-side check of this header against a
// mock of the CUDA runtime) gets the same instructions emulated in C++ with
// the flag in a variable; the ones that end a chain assert that no carry
// is lost.  nvcc compiles the asm bodies only, in both of its passes.
// ---------------------------------------------------------------------------
namespace ptx {

#ifdef __CUDACC__

#define TNSH_PTX2(name, text)                                               \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {        \
    uint32_t r;                                                             \
    asm volatile(text " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));           \
    return r;                                                               \
  }
#define TNSH_PTX3(name, text)                                               \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,          \
                                           uint32_t c) {                    \
    uint32_t r;                                                             \
    asm volatile(text " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                               \
  }

TNSH_PTX2(add_cc, "add.cc.u32")
TNSH_PTX2(addc_cc, "addc.cc.u32")
TNSH_PTX2(addc, "addc.u32")
TNSH_PTX2(sub_cc, "sub.cc.u32")
TNSH_PTX2(subc_cc, "subc.cc.u32")
TNSH_PTX2(subc, "subc.u32")
TNSH_PTX2(mul_lo, "mul.lo.u32")
TNSH_PTX2(mul_hi, "mul.hi.u32")
TNSH_PTX3(mad_lo_cc, "mad.lo.cc.u32")
TNSH_PTX3(madc_lo_cc, "madc.lo.cc.u32")
TNSH_PTX3(madc_hi_cc, "madc.hi.cc.u32")
TNSH_PTX3(madc_hi, "madc.hi.u32")

#undef TNSH_PTX2
#undef TNSH_PTX3

#else  // not nvcc: the instructions emulated, for a host-side check

static thread_local uint32_t cf = 0;

inline uint32_t emu(uint64_t wide, bool sets_flag) {
  if (sets_flag) {
    cf = (uint32_t)(wide >> 32) & 1u;
  } else {
    assert((wide >> 32) == 0 && "a chain's last instruction lost a carry");
  }
  return (uint32_t)wide;
}
inline uint32_t emu_sub(uint32_t a, uint32_t b, uint32_t borrow,
                        bool sets_flag) {
  const uint64_t wide = (uint64_t)a - b - borrow;
  if (sets_flag) cf = (uint32_t)(wide >> 63);
  return (uint32_t)wide;
}
inline uint32_t lo32(uint32_t a, uint32_t b) { return a * b; }
inline uint32_t hi32(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  return emu((uint64_t)a + b, true);
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return emu((uint64_t)a + b + cf, true);
}
inline uint32_t addc(uint32_t a, uint32_t b) {
  return emu((uint64_t)a + b + cf, false);
}
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  return emu_sub(a, b, 0, true);
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return emu_sub(a, b, cf, true);
}
inline uint32_t subc(uint32_t a, uint32_t b) {
  return emu_sub(a, b, cf, false);
}
inline uint32_t mul_lo(uint32_t a, uint32_t b) { return lo32(a, b); }
inline uint32_t mul_hi(uint32_t a, uint32_t b) { return hi32(a, b); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return emu((uint64_t)lo32(a, b) + c, true);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return emu((uint64_t)lo32(a, b) + c + cf, true);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return emu((uint64_t)hi32(a, b) + c + cf, true);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return emu((uint64_t)hi32(a, b) + c + cf, false);
}

#endif

}  // namespace ptx

// a <- a - 2p if a >= 2p: one borrow chain, then a select on the borrow.
template <class F>
__device__ __forceinline__ void fe_reduce_2p(uint32_t a[L]) {
  uint32_t d[L];
  d[0] = ptx::sub_cc(a[0], F::p2(0));
#pragma unroll
  for (int k = 1; k < L; ++k) d[k] = ptx::subc_cc(a[k], F::p2(k));
  const uint32_t borrow = ptx::subc(0, 0);  // all ones when a < 2p
#pragma unroll
  for (int k = 0; k < L; ++k) a[k] = borrow ? a[k] : d[k];
}

// r = a + b in the 2p-domain; a, b < 2p so a + b < 4p < 2^256.
template <class F>
__device__ __forceinline__ void fe_add(uint32_t r[L], const uint32_t a[L],
                                       const uint32_t b[L]) {
  r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < L - 1; ++k) r[k] = ptx::addc_cc(a[k], b[k]);
  r[L - 1] = ptx::addc(a[L - 1], b[L - 1]);
  fe_reduce_2p<F>(r);
}

// r = a - b, plus 2p when it borrows; a, b < 2p keeps r in [0, 2p).
template <class F>
__device__ __forceinline__ void fe_sub(uint32_t r[L], const uint32_t a[L],
                                       const uint32_t b[L]) {
  r[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < L; ++k) r[k] = ptx::subc_cc(a[k], b[k]);
  const uint32_t borrow = ptx::subc(0, 0);  // all ones when a < b
  r[0] = ptx::add_cc(r[0], F::p2(0) & borrow);
#pragma unroll
  for (int k = 1; k < L - 1; ++k) r[k] = ptx::addc_cc(r[k], F::p2(k) & borrow);
  // the sum wraps past 2^256 exactly when it borrowed: that carry is meant
  // to go
  r[L - 1] = ptx::addc_cc(r[L - 1], F::p2(L - 1) & borrow);
}

// True for both representations of zero in the 2p-domain: 0 and p.
template <class F>
__device__ __forceinline__ bool fe_is_zero(const uint32_t a[L]) {
  uint32_t any = 0, diff = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    any |= a[k];
    diff |= a[k] ^ F::p(k);
  }
  return any == 0 || diff == 0;
}

// ---------------------------------------------------------------------------
// Montgomery multiply: r = a * b * 2^-256 mod p, word-serial (CIOS) over
// the words of b.  Inputs < 2p and 4p < 2^256 give an output < 2p, so no
// final subtraction is needed.  r may alias a or b.
//
// The running sum is kept as two 8-word numbers, T = A + B * 2^32.  A
// 32x32-bit product fills an aligned pair of words, so the four products
// of a row with the even words of `a` go into A and the four with the odd
// words into B (one word up), each row one carry chain of mad.lo.cc /
// madc.hi.cc with no 64-bit intermediate and no carry word between
// columns; the chains of A and B are independent.  The reduction row
// (m = A[0] * N0, T += m * p) is laid out the same way.  It zeroes A[0];
// dividing by 2^32 then swaps the roles: B becomes the next A, and
// A >> 64 the next B, which the next row's first chain does while it
// accumulates (A[1], the word between, is added to the new A[0] and its
// carry starts that chain).
//
// Carries: a chain into A may carry out of its 8 words; that bit has B[7]'s
// weight and is added there.  B cannot overflow: T < 2^288 before every
// division (T_i < (a + p)(1 + 2^-31) < 2^256 after it, as a < 2p and
// 4p < 2^256), A >= 0, and every value B takes is a partial sum of
// non-negative parts of its final one, so B <= T / 2^32 < 2^256.
//
// (ab + mp) / R with m fixed by ab mod R is the same integer whatever the
// schedule, so the eight limbs equal those of any other CIOS or SOS body.
// ---------------------------------------------------------------------------
template <class F, bool kFirst>
__device__ __forceinline__ void mont_row(uint32_t A[L], uint32_t B[L],
                                         const uint32_t a[L], uint32_t bi) {
  if (kFirst) {
#pragma unroll
    for (int j = 0; j < L; j += 2) {
      A[j] = ptx::mul_lo(a[j], bi);
      A[j + 1] = ptx::mul_hi(a[j], bi);
      B[j] = ptx::mul_lo(a[j + 1], bi);
      B[j + 1] = ptx::mul_hi(a[j + 1], bi);
    }
  } else {
    // here A is the row before's B, and B the row before's A, whose word 0
    // is zero: B[1] belongs to A[0], B[2..7] are the next B[0..5]
    A[0] = ptx::add_cc(A[0], B[1]);
#pragma unroll
    for (int j = 0; j < L - 2; j += 2) {
      B[j] = ptx::madc_lo_cc(a[j + 1], bi, B[j + 2]);
      B[j + 1] = ptx::madc_hi_cc(a[j + 1], bi, B[j + 3]);
    }
    B[L - 2] = ptx::madc_lo_cc(a[L - 1], bi, 0);
    B[L - 1] = ptx::madc_hi(a[L - 1], bi, 0);
    A[0] = ptx::mad_lo_cc(a[0], bi, A[0]);
    A[1] = ptx::madc_hi_cc(a[0], bi, A[1]);
#pragma unroll
    for (int j = 2; j < L; j += 2) {
      A[j] = ptx::madc_lo_cc(a[j], bi, A[j]);
      A[j + 1] = ptx::madc_hi_cc(a[j], bi, A[j + 1]);
    }
    B[L - 1] = ptx::addc(B[L - 1], 0);
  }
  const uint32_t m = ptx::mul_lo(A[0], F::N0);
  B[0] = ptx::mad_lo_cc(F::p(1), m, B[0]);
  B[1] = ptx::madc_hi_cc(F::p(1), m, B[1]);
#pragma unroll
  for (int j = 2; j < L - 2; j += 2) {
    B[j] = ptx::madc_lo_cc(F::p(j + 1), m, B[j]);
    B[j + 1] = ptx::madc_hi_cc(F::p(j + 1), m, B[j + 1]);
  }
  B[L - 2] = ptx::madc_lo_cc(F::p(L - 1), m, B[L - 2]);
  B[L - 1] = ptx::madc_hi(F::p(L - 1), m, B[L - 1]);
  A[0] = ptx::mad_lo_cc(F::p(0), m, A[0]);
  A[1] = ptx::madc_hi_cc(F::p(0), m, A[1]);
#pragma unroll
  for (int j = 2; j < L; j += 2) {
    A[j] = ptx::madc_lo_cc(F::p(j), m, A[j]);
    A[j + 1] = ptx::madc_hi_cc(F::p(j), m, A[j + 1]);
  }
  B[L - 1] = ptx::addc(B[L - 1], 0);
}

template <class F>
__device__ __forceinline__ void fe_mul(uint32_t r[L], const uint32_t a[L],
                                       const uint32_t b[L]) {
  uint32_t u[L], v[L];
  mont_row<F, true>(u, v, a, b[0]);
#pragma unroll
  for (int i = 1; i < L; i += 2) {
    mont_row<F, false>(v, u, a, b[i]);
    if (i + 1 < L) mont_row<F, false>(u, v, a, b[i + 1]);
  }
  // the last row left A in v (word 0 zero) and B in u: r = (v >> 32) + u
  r[0] = ptx::add_cc(v[1], u[0]);
#pragma unroll
  for (int k = 1; k < L - 1; ++k) r[k] = ptx::addc_cc(v[k + 1], u[k]);
  r[L - 1] = ptx::addc(u[L - 1], 0);
}

// ---------------------------------------------------------------------------
// mont_mul_chain (replaces fr_pallas._chain_call): out = x * y^iters.
// The TPU keeps the accumulator in VMEM across a sequential (block, iter)
// grid; here each thread owns one lane and loops over iters in registers.
// x is a batch of (8, n) tables; y is (8, n) or (8, 1), broadcast over the
// batch (y_n == 1 broadcasts one element over all lanes).  iters = 1 is the
// elementwise Montgomery product, which is how both fields convert to
// Montgomery form (y = R^2 mod p).
// ---------------------------------------------------------------------------
template <class F>
__global__ void fe_chain_kernel(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                uint32_t* __restrict__ out, long long n,
                                long long batch, long long y_n, int iters) {
  const long long total = batch * n;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x) {
    const long long b = g / n;
    const long long i = g - b * n;
    uint32_t acc[L], yv[L];
    fe_load(acc, x + b * L * n + i, n);
    fe_load(yv, y + (y_n == 1 ? 0 : i), y_n);
    for (int s = 0; s < iters; ++s) fe_mul<F>(acc, acc, yv);
    fe_store(out + b * L * n + i, n, acc);
  }
}

constexpr int kThreads = 256;

// The current device's SM count, asked of the runtime once a device.  A
// failed runtime call is returned to the caller, never guessed around.
inline cudaError_t sm_count(int* sms) {
  constexpr int kCached = 64;
  static int cached[kCached] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kCached;
  if (keep && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && keep) cached[dev] = *sms;
  return err;
}

// Blocks of `threads` for `work` items, grid-stride beyond `per_sm` blocks
// an SM; never fewer than one.
inline cudaError_t grid_for(long long work, int threads, int per_sm,
                            int* blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  long long want = (work + threads - 1) / threads;
  const long long cap = (long long)sms * per_sm;
  if (want > cap) want = cap;
  *blocks = (int)(want < 1 ? 1 : want);
  return cudaSuccess;
}

constexpr int kBlocksPerSm = 64;

template <class F>
inline int launch_chain(const void* x, const void* y, void* out, long long n,
                        long long batch, long long y_n, int iters,
                        void* stream) {
  const long long total = batch * n;
  if (total > 0) {
    int blocks = 0;
    const cudaError_t err = grid_for(total, kThreads, kBlocksPerSm, &blocks);
    if (err != cudaSuccess) return (int)err;
    fe_chain_kernel<F><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, batch, y_n,
        iters);
  }
  return (int)cudaGetLastError();
}

}  // namespace tnsh
