// BN254 G1 kernels for Hopper (sm_90a): the commitment MSM on the card.
//
// Field arithmetic over Fq and the element layout are in field.cuh (shared
// with fr_kernels.cu).  A G1 point is three (8, N) Fq tables X, Y, Z in
// Jacobian coordinates (infinity: Z = 0), or two tables x, y when affine.
//
//   fe_chain_kernel<FqField>  Fq Montgomery product per lane (field.cuh);
//                             converts the SRS bases to Montgomery form.
//   g1_padd_kernel            general Jacobian add per lane, with the
//                             equal-point doubling and both infinities,
//                             and an optional lane mask: the group fold,
//                             suffix scan and tree sum around the insertion
//                             (XLA code in tnsh/commit/msm_jax.py _padd,
//                             a kernel here so those stages do not run on
//                             hundreds of small tensor ops).
//   msm_insert_kernel         <- tnsh/commit/msm_sched.py
//                             _make_insert_seg_cached / seg_kernel, the
//                             scheduled bucket insertion (TPU kernel #5).
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
// What bounds it: operations, and before that occupancy.  A step is 11 Fq
// products (1,496 32-bit multiply instructions) a lane against 68 bytes
// read, so memory is far away; but the plan has 4,096 accumulator lanes,
// one thread each, on a card that holds some 270 thousand threads, so most
// SMs idle and a thread's own dependent chain sets the time.  A wider plan
// or a batch axis over the columns of a proof is later work.

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
// General Jacobian add per lane: out = P1 + P2 where mask is set (or
// everywhere without a mask), else P1.  Handles P1 or P2 at infinity,
// inverse points (the formula gives Z3 = 0) and equal points (doubling).
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
    uint32_t X2[L], Y2[L], Z2[L];
    fe_load(X2, x2 + i, n);
    fe_load(Y2, y2 + i, n);
    fe_load(Z2, z2 + i, n);
    const bool p_inf = fq_is_zero(Z1);
    const bool q_inf = fq_is_zero(Z2);
    if (p_inf) {
      fe_store(ox + i, n, X2);
      fe_store(oy + i, n, Y2);
      fe_store(oz + i, n, Z2);
      continue;
    }
    if (q_inf) {
      fe_store(ox + i, n, X1);
      fe_store(oy + i, n, Y1);
      fe_store(oz + i, n, Z1);
      continue;
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
    uint32_t X3[L], Y3[L], Z3[L];
    if (fq_is_zero(H) && fq_is_zero(r)) {
      g1_double(X3, Y3, Z3, X1, Y1, Z1);
    } else {
      uint32_t I[L], J[L], V[L], T[L];
      fq_add(r, r, r);
      fq_add(I, H, H);     // H2
      fq_mul(I, I, I);
      fq_mul(T, r, r);     // RR
      fq_mul(J, H, I);
      fq_mul(V, U1, I);
      fq_mul(Z3, Z1, Z2);  // ZZ
      fq_sub(X3, T, J);
      fq_add(T, V, V);
      fq_sub(X3, X3, T);
      fq_sub(T, V, X3);
      fq_mul(T, r, T);     // RVX
      fq_mul(J, S1, J);    // SJ
      fq_mul(Z3, Z3, H);   // ZZH
      fq_add(J, J, J);
      fq_sub(Y3, T, J);
      fq_add(Z3, Z3, Z3);
    }
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
// ---------------------------------------------------------------------------
__global__ void msm_insert_kernel(const int* __restrict__ sched,
                                  long long lanes, int steps,
                                  const uint32_t* __restrict__ px,
                                  const uint32_t* __restrict__ py,
                                  long long pstride, long long m,
                                  const uint32_t* __restrict__ inx,
                                  const uint32_t* __restrict__ iny,
                                  const uint32_t* __restrict__ inz,
                                  uint32_t* __restrict__ ox,
                                  uint32_t* __restrict__ oy,
                                  uint32_t* __restrict__ oz,
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

constexpr int kPointThreads = 128;

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
    g1_padd_kernel<<<grid_for(n, kPointThreads), kPointThreads, 0,
                     (cudaStream_t)stream>>>(
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
    const int blocks = (int)((lanes + kPointThreads - 1) / kPointThreads);
    msm_insert_kernel<<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
        (const int*)sched, lanes, steps, (const uint32_t*)px,
        (const uint32_t*)py, pstride, m, (const uint32_t*)inx,
        (const uint32_t*)iny, (const uint32_t*)inz, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, (int*)hazards);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
