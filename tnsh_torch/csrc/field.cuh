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
// This is plain C++: one CIOS product is 64 + 64 32x32->64-bit
// multiply-adds plus carries, all in registers.  Carry chains in PTX
// (add.cc / madc) are later work.

#pragma once

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

// a <- a - 2p if a >= 2p.
template <class F>
__device__ __forceinline__ void fe_reduce_2p(uint32_t a[L]) {
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    uint64_t t = (uint64_t)a[k] - F::p2(k) - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (!borrow) fe_copy(a, d);
}

// r = a + b in the 2p-domain; a, b < 2p so a + b < 4p < 2^256.
template <class F>
__device__ __forceinline__ void fe_add(uint32_t r[L], const uint32_t a[L],
                                       const uint32_t b[L]) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    uint64_t t = (uint64_t)a[k] + b[k] + carry;
    r[k] = (uint32_t)t;
    carry = t >> 32;
  }
  fe_reduce_2p<F>(r);
}

// r = a - b, plus 2p when it borrows; a, b < 2p keeps r in [0, 2p).
template <class F>
__device__ __forceinline__ void fe_sub(uint32_t r[L], const uint32_t a[L],
                                       const uint32_t b[L]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    r[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      uint64_t t = (uint64_t)r[k] + F::p2(k) + carry;
      r[k] = (uint32_t)t;
      carry = t >> 32;
    }
  }
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

// CIOS Montgomery multiply: r = a * b * 2^-256 mod p.  Inputs < 2p and
// 4p < 2^256 give an output < 2p, so no final subtraction is needed.
// r may alias a or b.
template <class F>
__device__ __forceinline__ void fe_mul(uint32_t r[L], const uint32_t a[L],
                                       const uint32_t b[L]) {
  uint32_t t[L + 2];
#pragma unroll
  for (int k = 0; k < L + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint64_t uv = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)uv;
      c = uv >> 32;
    }
    uint64_t uv = (uint64_t)t[L] + c;
    t[L] = (uint32_t)uv;
    t[L + 1] = (uint32_t)(uv >> 32);
    uint32_t m = t[0] * F::N0;
    uv = (uint64_t)m * F::p(0) + t[0];
    c = uv >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      uv = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)uv;
      c = uv >> 32;
    }
    uv = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)uv;
    t[L] = t[L + 1] + (uint32_t)(uv >> 32);
  }
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = t[k];
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

inline int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

template <class F>
inline int launch_chain(const void* x, const void* y, void* out, long long n,
                        long long batch, long long y_n, int iters,
                        void* stream) {
  const long long total = batch * n;
  if (total > 0) {
    fe_chain_kernel<F><<<grid_for(total, kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, batch, y_n,
        iters);
  }
  return (int)cudaGetLastError();
}

}  // namespace tnsh
