// tnsh native host layer — BN254 field/curve/pairing kernels.
//
// This is the C++ counterpart of the reference's arkworks dependency stack
// (SURVEY §2 D1/D2): 4x64-limb Montgomery arithmetic for Fq and Fr, G1/G2
// Jacobian groups, Pippenger MSM, tower-field (Fq2/Fq6/Fq12) optimal ate
// pairing, and the Fr polynomial kernels on the prover's host path (Newton
// interpolation over {0..n-1}, Horner, synthetic division).
//
// Exposed as a plain C ABI over little-endian byte buffers (32 B per field
// element, 64 B per affine G1 point, 128 B per affine G2 point; the identity
// is all-zero) and loaded from Python with ctypes (tnsh/_native/__init__.py).
// All values crossing the ABI are canonical standard-form integers; the
// Montgomery representation is internal.  Every function is exact, so
// results are bit-identical to the pure-Python golden path (asserted in
// tests/test_native.py).

#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Generic 4x64 Montgomery field
// ---------------------------------------------------------------------------

struct Field {
    u64 p[4];   // modulus, little-endian limbs
    u64 n0;     // -p^{-1} mod 2^64
    u64 r2[4];  // R^2 mod p (R = 2^256), Montgomery form of R
    u64 one[4]; // R mod p, Montgomery form of 1
};

static bool geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;
}

static void sub_raw(u64 r[4], const u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - (u64)borrow;
        r[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static void add_mod(u64 r[4], const u64 a[4], const u64 b[4], const Field &F) {
    u128 carry = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a[i] + b[i] + (u64)carry;
        t[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq(t, F.p)) {
        sub_raw(r, t, F.p);
    } else {
        memcpy(r, t, 32);
    }
}

static void sub_mod(u64 r[4], const u64 a[4], const u64 b[4], const Field &F) {
    if (geq(a, b)) {
        sub_raw(r, a, b);
    } else {
        u64 t[4];
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)a[i] + F.p[i] + (u64)carry;
            t[i] = (u64)s;
            carry = s >> 64;
        }
        sub_raw(r, t, b);
    }
}

static void neg_mod(u64 r[4], const u64 a[4], const Field &F) {
    if ((a[0] | a[1] | a[2] | a[3]) == 0) {
        memset(r, 0, 32);
    } else {
        sub_raw(r, F.p, a);
    }
}

// CIOS Montgomery multiplication.
static void mmul(u64 r[4], const u64 a[4], const u64 b[4], const Field &F) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)a[i] * b[j] + (u64)c;
            t[j] = (u64)s;
            c = s >> 64;
        }
        u128 s = (u128)t[4] + (u64)c;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);
        u64 m = t[0] * F.n0;
        c = 0;
        for (int j = 0; j < 4; j++) {
            u128 s2 = (u128)t[j] + (u128)m * F.p[j] + (u64)c;
            t[j] = (u64)s2;
            c = s2 >> 64;
        }
        s = (u128)t[4] + (u64)c;
        t[4] = (u64)s;
        u64 carry2 = (u64)(s >> 64);
        t[0] = t[1];
        t[1] = t[2];
        t[2] = t[3];
        t[3] = t[4];
        t[4] = t[5] + carry2;
        t[5] = 0;
    }
    if (t[4] || geq(t, F.p)) {
        sub_raw(r, t, F.p);
    } else {
        memcpy(r, t, 32);
    }
}

static void msq(u64 r[4], const u64 a[4], const Field &F) { mmul(r, a, a, F); }

static bool is_zero4(const u64 a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

// Montgomery exponentiation (exponent as raw 4x64, NOT Montgomery).
static void mpow(u64 r[4], const u64 a[4], const u64 e[4], const Field &F) {
    u64 base[4], acc[4];
    memcpy(base, a, 32);
    memcpy(acc, F.one, 32);
    for (int limb = 0; limb < 4; limb++) {
        u64 bits = e[limb];
        for (int i = 0; i < 64; i++) {
            if ((bits >> i) & 1) mmul(acc, acc, base, F);
            msq(base, base, F);
        }
    }
    memcpy(r, acc, 32);
}

static void minv(u64 r[4], const u64 a[4], const Field &F) {
    u64 e[4];
    memcpy(e, F.p, 32);
    // e = p - 2
    u64 two[4] = {2, 0, 0, 0};
    sub_raw(e, e, two);
    mpow(r, a, e, F);
}

static void to_mont(u64 r[4], const u64 a[4], const Field &F) {
    mmul(r, a, F.r2, F);
}

static void from_mont(u64 r[4], const u64 a[4], const Field &F) {
    u64 one_raw[4] = {1, 0, 0, 0};
    mmul(r, a, one_raw, F);
}

static void bytes_to_limbs(u64 out[4], const uint8_t *in) {
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | in[i * 8 + j];
        out[i] = v;
    }
}

static void limbs_to_bytes(uint8_t *out, const u64 in[4]) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) out[i * 8 + j] = (uint8_t)(in[i] >> (8 * j));
}

static Field make_field(const u64 p[4]) {
    Field F;
    memcpy(F.p, p, 32);
    // n0 = -p^{-1} mod 2^64 by Newton iteration
    u64 inv = p[0];
    for (int i = 0; i < 6; i++) inv *= 2 - p[0] * inv;
    F.n0 = (u64)(0 - inv);
    // one = R mod p: start from 2^255 mod p... build by doubling 1, 256x
    u64 acc[4] = {1, 0, 0, 0};
    for (int i = 0; i < 256; i++) add_mod(acc, acc, acc, F);
    memcpy(F.one, acc, 32);
    // r2 = R^2 mod p: double 256 more times
    for (int i = 0; i < 256; i++) add_mod(acc, acc, acc, F);
    memcpy(F.r2, acc, 32);
    return F;
}

// BN254 moduli
static const u64 FQ_P[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                            0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 FR_P[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                            0xb85045b68181585dULL, 0x30644e72e131a029ULL};

static Field FQ = make_field(FQ_P);
static Field FR = make_field(FR_P);

// BN curve parameter 6u+2 (Miller loop count) = 29793968203157093288 — 65
// bits, so stored as u128.
static const u128 ATE_LOOP = (((u128)1) << 64) | 11347224129447541672ULL;

// ---------------------------------------------------------------------------
// Fq2 = Fq[i]/(i^2 + 1)
// ---------------------------------------------------------------------------

struct Fq2 {
    u64 c0[4], c1[4];
};

static Fq2 fq2_zero() { Fq2 r; memset(&r, 0, sizeof(r)); return r; }
static Fq2 fq2_one() { Fq2 r = fq2_zero(); memcpy(r.c0, FQ.one, 32); return r; }

static bool fq2_is_zero(const Fq2 &a) { return is_zero4(a.c0) && is_zero4(a.c1); }
static bool fq2_eq(const Fq2 &a, const Fq2 &b) {
    return memcmp(a.c0, b.c0, 32) == 0 && memcmp(a.c1, b.c1, 32) == 0;
}

static Fq2 fq2_add(const Fq2 &a, const Fq2 &b) {
    Fq2 r;
    add_mod(r.c0, a.c0, b.c0, FQ);
    add_mod(r.c1, a.c1, b.c1, FQ);
    return r;
}

static Fq2 fq2_sub(const Fq2 &a, const Fq2 &b) {
    Fq2 r;
    sub_mod(r.c0, a.c0, b.c0, FQ);
    sub_mod(r.c1, a.c1, b.c1, FQ);
    return r;
}

static Fq2 fq2_neg(const Fq2 &a) {
    Fq2 r;
    neg_mod(r.c0, a.c0, FQ);
    neg_mod(r.c1, a.c1, FQ);
    return r;
}

static Fq2 fq2_mul(const Fq2 &a, const Fq2 &b) {
    // Karatsuba: (a0+a1 i)(b0+b1 i) = a0b0 - a1b1 + ((a0+a1)(b0+b1)-a0b0-a1b1) i
    u64 t0[4], t1[4], s0[4], s1[4], s2[4];
    mmul(t0, a.c0, b.c0, FQ);
    mmul(t1, a.c1, b.c1, FQ);
    add_mod(s0, a.c0, a.c1, FQ);
    add_mod(s1, b.c0, b.c1, FQ);
    mmul(s2, s0, s1, FQ);
    Fq2 r;
    sub_mod(r.c0, t0, t1, FQ);
    sub_mod(s2, s2, t0, FQ);
    sub_mod(r.c1, s2, t1, FQ);
    return r;
}

static Fq2 fq2_sqr(const Fq2 &a) { return fq2_mul(a, a); }

static Fq2 fq2_scalar(const Fq2 &a, const u64 k[4]) {  // k in Montgomery
    Fq2 r;
    mmul(r.c0, a.c0, k, FQ);
    mmul(r.c1, a.c1, k, FQ);
    return r;
}

static Fq2 fq2_dbl(const Fq2 &a) { return fq2_add(a, a); }

static Fq2 fq2_inv(const Fq2 &a) {
    u64 t0[4], t1[4], n[4], ninv[4];
    msq(t0, a.c0, FQ);
    msq(t1, a.c1, FQ);
    add_mod(n, t0, t1, FQ);
    minv(ninv, n, FQ);
    Fq2 r;
    mmul(r.c0, a.c0, ninv, FQ);
    u64 nc1[4];
    neg_mod(nc1, a.c1, FQ);
    mmul(r.c1, nc1, ninv, FQ);
    return r;
}

// xi = 9 + i (the sextic non-residue for the tower)
static Fq2 fq2_mul_by_xi(const Fq2 &a) {
    // (9 a0 - a1) + (a0 + 9 a1) i
    u64 t[4], nine_a0[4], nine_a1[4];
    Fq2 r;
    memcpy(t, a.c0, 32);
    add_mod(t, t, t, FQ);          // 2a0
    add_mod(t, t, t, FQ);          // 4a0
    add_mod(t, t, t, FQ);          // 8a0
    add_mod(nine_a0, t, a.c0, FQ); // 9a0
    memcpy(t, a.c1, 32);
    add_mod(t, t, t, FQ);
    add_mod(t, t, t, FQ);
    add_mod(t, t, t, FQ);
    add_mod(nine_a1, t, a.c1, FQ);
    sub_mod(r.c0, nine_a0, a.c1, FQ);
    add_mod(r.c1, a.c0, nine_a1, FQ);
    return r;
}

static Fq2 fq2_conj(const Fq2 &a) {
    Fq2 r;
    memcpy(r.c0, a.c0, 32);
    neg_mod(r.c1, a.c1, FQ);
    return r;
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fq6 {
    Fq2 c0, c1, c2;
};

struct Fq12 {
    Fq6 c0, c1;
};

static Fq6 fq6_zero() { Fq6 r; memset(&r, 0, sizeof(r)); return r; }
static Fq6 fq6_one() { Fq6 r = fq6_zero(); r.c0 = fq2_one(); return r; }

static Fq6 fq6_add(const Fq6 &a, const Fq6 &b) {
    Fq6 r;
    r.c0 = fq2_add(a.c0, b.c0);
    r.c1 = fq2_add(a.c1, b.c1);
    r.c2 = fq2_add(a.c2, b.c2);
    return r;
}

static Fq6 fq6_sub(const Fq6 &a, const Fq6 &b) {
    Fq6 r;
    r.c0 = fq2_sub(a.c0, b.c0);
    r.c1 = fq2_sub(a.c1, b.c1);
    r.c2 = fq2_sub(a.c2, b.c2);
    return r;
}

static Fq6 fq6_neg(const Fq6 &a) {
    Fq6 r;
    r.c0 = fq2_neg(a.c0);
    r.c1 = fq2_neg(a.c1);
    r.c2 = fq2_neg(a.c2);
    return r;
}

static Fq6 fq6_mul(const Fq6 &a, const Fq6 &b) {
    Fq2 aa = fq2_mul(a.c0, b.c0);
    Fq2 bb = fq2_mul(a.c1, b.c1);
    Fq2 cc = fq2_mul(a.c2, b.c2);
    Fq2 t1 = fq2_sub(fq2_sub(fq2_mul(fq2_add(a.c1, a.c2), fq2_add(b.c1, b.c2)), bb), cc);
    Fq2 t2 = fq2_sub(fq2_sub(fq2_mul(fq2_add(a.c0, a.c1), fq2_add(b.c0, b.c1)), aa), bb);
    Fq2 t3 = fq2_sub(fq2_sub(fq2_mul(fq2_add(a.c0, a.c2), fq2_add(b.c0, b.c2)), aa), cc);
    Fq6 r;
    r.c0 = fq2_add(aa, fq2_mul_by_xi(t1));
    r.c1 = fq2_add(t2, fq2_mul_by_xi(cc));
    r.c2 = fq2_add(t3, bb);
    return r;
}

static Fq6 fq6_sqr(const Fq6 &a) { return fq6_mul(a, a); }

// multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)
static Fq6 fq6_mul_by_v(const Fq6 &a) {
    Fq6 r;
    r.c0 = fq2_mul_by_xi(a.c2);
    r.c1 = a.c0;
    r.c2 = a.c1;
    return r;
}

static Fq6 fq6_inv(const Fq6 &a) {
    // Standard minors formula.
    Fq2 c0 = fq2_sub(fq2_sqr(a.c0), fq2_mul_by_xi(fq2_mul(a.c1, a.c2)));
    Fq2 c1 = fq2_sub(fq2_mul_by_xi(fq2_sqr(a.c2)), fq2_mul(a.c0, a.c1));
    Fq2 c2 = fq2_sub(fq2_sqr(a.c1), fq2_mul(a.c0, a.c2));
    Fq2 t = fq2_add(
        fq2_mul_by_xi(fq2_add(fq2_mul(a.c2, c1), fq2_mul(a.c1, c2))),
        fq2_mul(a.c0, c0));
    Fq2 tinv = fq2_inv(t);
    Fq6 r;
    r.c0 = fq2_mul(c0, tinv);
    r.c1 = fq2_mul(c1, tinv);
    r.c2 = fq2_mul(c2, tinv);
    return r;
}

static Fq12 fq12_one() { Fq12 r; r.c0 = fq6_one(); r.c1 = fq6_zero(); return r; }

static bool fq12_eq(const Fq12 &a, const Fq12 &b) {
    return memcmp(&a, &b, sizeof(Fq12)) == 0;
}

static Fq12 fq12_mul(const Fq12 &a, const Fq12 &b) {
    Fq6 aa = fq6_mul(a.c0, b.c0);
    Fq6 bb = fq6_mul(a.c1, b.c1);
    Fq12 r;
    r.c0 = fq6_add(aa, fq6_mul_by_v(bb));
    r.c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a.c0, a.c1), fq6_add(b.c0, b.c1)), aa), bb);
    return r;
}

static Fq12 fq12_sqr(const Fq12 &a) { return fq12_mul(a, a); }

static Fq12 fq12_conj(const Fq12 &a) {
    Fq12 r;
    r.c0 = a.c0;
    r.c1 = fq6_neg(a.c1);
    return r;
}

static Fq12 fq12_inv(const Fq12 &a) {
    Fq6 t = fq6_sub(fq6_sqr(a.c0), fq6_mul_by_v(fq6_sqr(a.c1)));
    Fq6 tinv = fq6_inv(t);
    Fq12 r;
    r.c0 = fq6_mul(a.c0, tinv);
    r.c1 = fq6_neg(fq6_mul(a.c1, tinv));
    return r;
}

// ---------------------------------------------------------------------------
// G1 (Jacobian over Fq)
// ---------------------------------------------------------------------------

struct G1J {
    u64 X[4], Y[4], Z[4];
};

static bool g1_is_zero(const G1J &p) { return is_zero4(p.Z); }

static G1J g1_zero() {
    G1J r;
    memcpy(r.X, FQ.one, 32);
    memcpy(r.Y, FQ.one, 32);
    memset(r.Z, 0, 32);
    return r;
}

static G1J g1_dbl(const G1J &p) {
    if (g1_is_zero(p)) return p;
    u64 A[4], Bv[4], C[4], D[4], E[4], Fv[4], t[4], X3[4], Y3[4], Z3[4];
    msq(A, p.X, FQ);
    msq(Bv, p.Y, FQ);
    msq(C, Bv, FQ);
    add_mod(t, p.X, Bv, FQ);
    msq(t, t, FQ);
    sub_mod(t, t, A, FQ);
    sub_mod(t, t, C, FQ);
    add_mod(D, t, t, FQ);
    add_mod(E, A, A, FQ);
    add_mod(E, E, A, FQ);
    msq(Fv, E, FQ);
    add_mod(t, D, D, FQ);
    sub_mod(X3, Fv, t, FQ);
    sub_mod(t, D, X3, FQ);
    mmul(Y3, E, t, FQ);
    add_mod(t, C, C, FQ);
    add_mod(t, t, t, FQ);
    add_mod(t, t, t, FQ);  // 8C
    sub_mod(Y3, Y3, t, FQ);
    mmul(Z3, p.Y, p.Z, FQ);
    add_mod(Z3, Z3, Z3, FQ);
    G1J r;
    memcpy(r.X, X3, 32);
    memcpy(r.Y, Y3, 32);
    memcpy(r.Z, Z3, 32);
    return r;
}

static G1J g1_add(const G1J &p, const G1J &q) {
    if (g1_is_zero(p)) return q;
    if (g1_is_zero(q)) return p;
    u64 Z1Z1[4], Z2Z2[4], U1[4], U2[4], S1[4], S2[4], H[4], I[4], J[4], rr[4],
        V[4], t[4], X3[4], Y3[4], Z3[4];
    msq(Z1Z1, p.Z, FQ);
    msq(Z2Z2, q.Z, FQ);
    mmul(U1, p.X, Z2Z2, FQ);
    mmul(U2, q.X, Z1Z1, FQ);
    mmul(S1, p.Y, q.Z, FQ);
    mmul(S1, S1, Z2Z2, FQ);
    mmul(S2, q.Y, p.Z, FQ);
    mmul(S2, S2, Z1Z1, FQ);
    sub_mod(H, U2, U1, FQ);
    sub_mod(rr, S2, S1, FQ);
    if (is_zero4(H)) {
        if (is_zero4(rr)) return g1_dbl(p);
        return g1_zero();
    }
    add_mod(rr, rr, rr, FQ);
    add_mod(t, H, H, FQ);
    msq(I, t, FQ);
    mmul(J, H, I, FQ);
    mmul(V, U1, I, FQ);
    msq(X3, rr, FQ);
    sub_mod(X3, X3, J, FQ);
    add_mod(t, V, V, FQ);
    sub_mod(X3, X3, t, FQ);
    sub_mod(t, V, X3, FQ);
    mmul(Y3, rr, t, FQ);
    mmul(t, S1, J, FQ);
    add_mod(t, t, t, FQ);
    sub_mod(Y3, Y3, t, FQ);
    mmul(Z3, p.Z, q.Z, FQ);
    mmul(Z3, Z3, H, FQ);
    add_mod(Z3, Z3, Z3, FQ);
    G1J r;
    memcpy(r.X, X3, 32);
    memcpy(r.Y, Y3, 32);
    memcpy(r.Z, Z3, 32);
    return r;
}

static void g1_to_affine(const G1J &p, u64 x[4], u64 y[4]) {
    if (g1_is_zero(p)) {
        memset(x, 0, 32);
        memset(y, 0, 32);
        return;
    }
    u64 zinv[4], zinv2[4];
    minv(zinv, p.Z, FQ);
    msq(zinv2, zinv, FQ);
    mmul(x, p.X, zinv2, FQ);
    mmul(y, p.Y, zinv2, FQ);
    mmul(y, y, zinv, FQ);
}

// bytes (affine standard form) -> Jacobian Montgomery; (0,0) = identity
static G1J g1_from_bytes(const uint8_t *buf) {
    u64 x[4], y[4];
    bytes_to_limbs(x, buf);
    bytes_to_limbs(y, buf + 32);
    if (is_zero4(x) && is_zero4(y)) return g1_zero();
    G1J r;
    to_mont(r.X, x, FQ);
    to_mont(r.Y, y, FQ);
    memcpy(r.Z, FQ.one, 32);
    return r;
}

static void g1_to_bytes(uint8_t *buf, const G1J &p) {
    u64 x[4], y[4], xs[4], ys[4];
    g1_to_affine(p, x, y);
    from_mont(xs, x, FQ);
    from_mont(ys, y, FQ);
    limbs_to_bytes(buf, xs);
    limbs_to_bytes(buf + 32, ys);
}

static G1J g1_scalar_mul_j(const G1J &p, const u64 k[4]) {
    // 4-bit windowed
    G1J table[16];
    table[0] = g1_zero();
    table[1] = p;
    for (int i = 2; i < 16; i++) table[i] = g1_add(table[i - 1], p);
    G1J acc = g1_zero();
    bool started = false;
    for (int limb = 3; limb >= 0; limb--) {
        for (int nib = 15; nib >= 0; nib--) {
            if (started) {
                acc = g1_dbl(acc);
                acc = g1_dbl(acc);
                acc = g1_dbl(acc);
                acc = g1_dbl(acc);
            }
            int d = (int)((k[limb] >> (nib * 4)) & 0xF);
            if (d) {
                acc = g1_add(acc, table[d]);
                started = true;
            } else if (started) {
                // nothing
            }
        }
    }
    return acc;
}

// ---------------------------------------------------------------------------
// G2 (Jacobian over Fq2)
// ---------------------------------------------------------------------------

struct G2J {
    Fq2 X, Y, Z;
};

static bool g2_is_zero(const G2J &p) { return fq2_is_zero(p.Z); }

static G2J g2_zero() {
    G2J r;
    r.X = fq2_one();
    r.Y = fq2_one();
    r.Z = fq2_zero();
    return r;
}

static G2J g2_dbl(const G2J &p) {
    if (g2_is_zero(p)) return p;
    Fq2 A = fq2_sqr(p.X);
    Fq2 B = fq2_sqr(p.Y);
    Fq2 C = fq2_sqr(B);
    Fq2 t = fq2_sqr(fq2_add(p.X, B));
    t = fq2_sub(fq2_sub(t, A), C);
    Fq2 D = fq2_dbl(t);
    Fq2 E = fq2_add(fq2_dbl(A), A);
    Fq2 F = fq2_sqr(E);
    G2J r;
    r.X = fq2_sub(F, fq2_dbl(D));
    Fq2 C8 = fq2_dbl(fq2_dbl(fq2_dbl(C)));
    r.Y = fq2_sub(fq2_mul(E, fq2_sub(D, r.X)), C8);
    r.Z = fq2_dbl(fq2_mul(p.Y, p.Z));
    return r;
}

static G2J g2_add(const G2J &p, const G2J &q) {
    if (g2_is_zero(p)) return q;
    if (g2_is_zero(q)) return p;
    Fq2 Z1Z1 = fq2_sqr(p.Z);
    Fq2 Z2Z2 = fq2_sqr(q.Z);
    Fq2 U1 = fq2_mul(p.X, Z2Z2);
    Fq2 U2 = fq2_mul(q.X, Z1Z1);
    Fq2 S1 = fq2_mul(fq2_mul(p.Y, q.Z), Z2Z2);
    Fq2 S2 = fq2_mul(fq2_mul(q.Y, p.Z), Z1Z1);
    Fq2 H = fq2_sub(U2, U1);
    Fq2 rr = fq2_sub(S2, S1);
    if (fq2_is_zero(H)) {
        if (fq2_is_zero(rr)) return g2_dbl(p);
        return g2_zero();
    }
    rr = fq2_dbl(rr);
    Fq2 I = fq2_sqr(fq2_dbl(H));
    Fq2 J = fq2_mul(H, I);
    Fq2 V = fq2_mul(U1, I);
    G2J r;
    r.X = fq2_sub(fq2_sub(fq2_sqr(rr), J), fq2_dbl(V));
    r.Y = fq2_sub(fq2_mul(rr, fq2_sub(V, r.X)),
                  fq2_dbl(fq2_mul(S1, J)));
    r.Z = fq2_dbl(fq2_mul(fq2_mul(p.Z, q.Z), H));
    return r;
}

static void g2_to_affine(const G2J &p, Fq2 &x, Fq2 &y) {
    if (g2_is_zero(p)) {
        x = fq2_zero();
        y = fq2_zero();
        return;
    }
    Fq2 zinv = fq2_inv(p.Z);
    Fq2 zinv2 = fq2_sqr(zinv);
    x = fq2_mul(p.X, zinv2);
    y = fq2_mul(fq2_mul(p.Y, zinv2), zinv);
}

static G2J g2_from_bytes(const uint8_t *buf) {
    u64 a[4];
    G2J r;
    bytes_to_limbs(a, buf);
    to_mont(r.X.c0, a, FQ);
    bytes_to_limbs(a, buf + 32);
    to_mont(r.X.c1, a, FQ);
    bytes_to_limbs(a, buf + 64);
    to_mont(r.Y.c0, a, FQ);
    bytes_to_limbs(a, buf + 96);
    to_mont(r.Y.c1, a, FQ);
    if (fq2_is_zero(r.X) && fq2_is_zero(r.Y)) return g2_zero();
    r.Z = fq2_one();
    return r;
}

static void g2_to_bytes(uint8_t *buf, const G2J &p) {
    Fq2 x, y;
    g2_to_affine(p, x, y);
    u64 s[4];
    from_mont(s, x.c0, FQ);
    limbs_to_bytes(buf, s);
    from_mont(s, x.c1, FQ);
    limbs_to_bytes(buf + 32, s);
    from_mont(s, y.c0, FQ);
    limbs_to_bytes(buf + 64, s);
    from_mont(s, y.c1, FQ);
    limbs_to_bytes(buf + 96, s);
}

static G2J g2_scalar_mul_j(const G2J &p, const u64 k[4]) {
    G2J table[16];
    table[0] = g2_zero();
    table[1] = p;
    for (int i = 2; i < 16; i++) table[i] = g2_add(table[i - 1], p);
    G2J acc = g2_zero();
    bool started = false;
    for (int limb = 3; limb >= 0; limb--) {
        for (int nib = 15; nib >= 0; nib--) {
            if (started) {
                acc = g2_dbl(acc);
                acc = g2_dbl(acc);
                acc = g2_dbl(acc);
                acc = g2_dbl(acc);
            }
            int d = (int)((k[limb] >> (nib * 4)) & 0xF);
            if (d) {
                acc = g2_add(acc, table[d]);
                started = true;
            }
        }
    }
    return acc;
}

// ---------------------------------------------------------------------------
// Pairing: optimal ate, untwisted affine line functions over Fq12
// ---------------------------------------------------------------------------
//
// G2 points untwist into E(Fq12): x' = x * v (Fq6 c1-slot), y' = y * v * w.
// Affine Miller loop matches the validated Python implementation
// (tnsh/field/pairing.py) structurally; the tower basis here satisfies
// w^2 = v, v^3 = xi = 9 + i, i.e. the same field with w^6 = xi.

struct PtE12 {
    Fq12 x, y;
};

static Fq12 fq12_from_fq(const u64 a_mont[4]) {
    Fq12 r;
    memset(&r, 0, sizeof(r));
    memcpy(r.c0.c0.c0, a_mont, 32);
    return r;
}

// x in Fq2 -> x * v  (c0 slot empty, c1 slot = x)
static Fq12 fq12_from_fq2_times_v(const Fq2 &x) {
    Fq12 r;
    memset(&r, 0, sizeof(r));
    r.c0.c1 = x;
    return r;
}

// y in Fq2 -> y * v * w
static Fq12 fq12_from_fq2_times_vw(const Fq2 &y) {
    Fq12 r;
    memset(&r, 0, sizeof(r));
    r.c1.c1 = y;
    return r;
}

static PtE12 untwist(const Fq2 &x, const Fq2 &y) {
    PtE12 p;
    p.x = fq12_from_fq2_times_v(x);
    p.y = fq12_from_fq2_times_vw(y);
    return p;
}

static Fq12 fq12_sub_(const Fq12 &a, const Fq12 &b) {
    Fq12 r;
    r.c0 = fq6_sub(a.c0, b.c0);
    r.c1 = fq6_sub(a.c1, b.c1);
    return r;
}

static Fq12 fq12_add_(const Fq12 &a, const Fq12 &b) {
    Fq12 r;
    r.c0 = fq6_add(a.c0, b.c0);
    r.c1 = fq6_add(a.c1, b.c1);
    return r;
}

static Fq12 fq12_dbl_(const Fq12 &a) { return fq12_add_(a, a); }

static PtE12 pt_dbl(const PtE12 &p) {
    // m = 3x^2 / 2y
    Fq12 xx = fq12_sqr(p.x);
    Fq12 num = fq12_add_(fq12_dbl_(xx), xx);
    Fq12 m = fq12_mul(num, fq12_inv(fq12_dbl_(p.y)));
    PtE12 r;
    r.x = fq12_sub_(fq12_sqr(m), fq12_dbl_(p.x));
    r.y = fq12_sub_(fq12_mul(m, fq12_sub_(p.x, r.x)), p.y);
    return r;
}

static PtE12 pt_add(const PtE12 &p1, const PtE12 &p2) {
    if (fq12_eq(p1.x, p2.x) && fq12_eq(p1.y, p2.y)) return pt_dbl(p1);
    Fq12 m = fq12_mul(fq12_sub_(p2.y, p1.y), fq12_inv(fq12_sub_(p2.x, p1.x)));
    PtE12 r;
    r.x = fq12_sub_(fq12_sub_(fq12_sqr(m), p1.x), p2.x);
    r.y = fq12_sub_(fq12_mul(m, fq12_sub_(p1.x, r.x)), p1.y);
    return r;
}

static Fq12 linefunc(const PtE12 &p1, const PtE12 &p2, const Fq12 &xt,
                     const Fq12 &yt) {
    if (!fq12_eq(p1.x, p2.x)) {
        Fq12 m = fq12_mul(fq12_sub_(p2.y, p1.y), fq12_inv(fq12_sub_(p2.x, p1.x)));
        return fq12_sub_(fq12_mul(m, fq12_sub_(xt, p1.x)), fq12_sub_(yt, p1.y));
    }
    if (fq12_eq(p1.y, p2.y)) {
        Fq12 xx = fq12_sqr(p1.x);
        Fq12 num = fq12_add_(fq12_dbl_(xx), xx);
        Fq12 m = fq12_mul(num, fq12_inv(fq12_dbl_(p1.y)));
        return fq12_sub_(fq12_mul(m, fq12_sub_(xt, p1.x)), fq12_sub_(yt, p1.y));
    }
    return fq12_sub_(xt, p1.x);
}

// Frobenius x -> x^q on Fq12 via exponentiation (slow path, done twice per
// Miller loop; acceptable at verify frequencies).
static Fq12 fq12_frob_fast(const Fq12 &a);
static Fq12 fq12_frob(const Fq12 &a) { return fq12_frob_fast(a); }

// ---- fast Frobenius via precomputed gamma = xi^((q-1)/6) powers ----

static Fq2 fq2_pow(const Fq2 &a, const u64 *e, int nlimbs) {
    Fq2 acc = fq2_one();
    Fq2 base = a;
    for (int limb = 0; limb < nlimbs; limb++) {
        u64 bits = e[limb];
        for (int i = 0; i < 64; i++) {
            if ((bits >> i) & 1) acc = fq2_mul(acc, base);
            base = fq2_sqr(base);
        }
    }
    return acc;
}

static const u64 Q_MINUS1_DIV6[4] = {0x34b017592414d4e1ULL, 0xee9591c2e6bda1c2ULL, 0xf40d60f3c0403964ULL, 0x0810b7bdd032f006ULL};

Fq2 FROB_GAMMA[6];
bool FROB_READY = false;

static void init_frob() {
    // xi = 9 + i in Montgomery form
    Fq2 xi = fq2_zero();
    u64 nine_raw[4] = {9, 0, 0, 0};
    to_mont(xi.c0, nine_raw, FQ);
    memcpy(xi.c1, FQ.one, 32);
    Fq2 g = fq2_pow(xi, Q_MINUS1_DIV6, 4);
    FROB_GAMMA[0] = fq2_one();
    for (int i = 1; i < 6; i++) FROB_GAMMA[i] = fq2_mul(FROB_GAMMA[i - 1], g);
    FROB_READY = true;
}

// x -> x^q: conjugate each Fq2 coefficient, multiply slot (j,k) by
// gamma^(2j+k)  (v^q = gamma^2 v, w^q = gamma w).
static Fq12 fq12_frob_fast(const Fq12 &a) {
    if (!FROB_READY) init_frob();
    Fq12 r;
    const Fq2 *in[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2,
                        &a.c1.c0, &a.c1.c1, &a.c1.c2};
    Fq2 *out[6] = {&r.c0.c0, &r.c0.c1, &r.c0.c2,
                   &r.c1.c0, &r.c1.c1, &r.c1.c2};
    for (int k = 0; k < 2; k++)
        for (int j = 0; j < 3; j++) {
            int slot = k * 3 + j;
            *out[slot] = fq2_mul(fq2_conj(*in[slot]), FROB_GAMMA[2 * j + k]);
        }
    return r;
}

static Fq12 miller_loop(const Fq2 &qx, const Fq2 &qy, const u64 px_m[4],
                        const u64 py_m[4]) {
    // Twisted-coordinate Miller loop: the running point R stays in affine
    // E'(Fq2); slopes are Fq2 (one Fq2 inversion per step instead of Fq12),
    // and each line value is assembled sparsely as
    //   l = -yp + (lam * xp) w + (y_R - lam * x_R) v w,
    // which equals the untwisted-coordinate line exactly (validated against
    // the Python flat-Fq12 Miller loop bit-for-bit).
    if (!FROB_READY) init_frob();
    Fq2 rx = qx, ry = qy;
    Fq12 f = fq12_one();

    auto line = [&](const Fq2 &lam, const Fq2 &x1, const Fq2 &y1) {
        Fq12 l;
        memset(&l, 0, sizeof(l));
        neg_mod(l.c0.c0.c0, py_m, FQ);
        mmul(l.c1.c0.c0, lam.c0, px_m, FQ);
        mmul(l.c1.c0.c1, lam.c1, px_m, FQ);
        l.c1.c1 = fq2_sub(y1, fq2_mul(lam, x1));
        return l;
    };

    auto dbl_step = [&]() {
        Fq2 xx = fq2_sqr(rx);
        Fq2 num = fq2_add(fq2_dbl(xx), xx);
        Fq2 lam = fq2_mul(num, fq2_inv(fq2_dbl(ry)));
        Fq12 l = line(lam, rx, ry);
        Fq2 x3 = fq2_sub(fq2_sqr(lam), fq2_dbl(rx));
        ry = fq2_sub(fq2_mul(lam, fq2_sub(rx, x3)), ry);
        rx = x3;
        return l;
    };

    auto add_step = [&](const Fq2 &ax, const Fq2 &ay) {
        Fq2 lam = fq2_mul(fq2_sub(ay, ry), fq2_inv(fq2_sub(ax, rx)));
        Fq12 l = line(lam, rx, ry);
        Fq2 x3 = fq2_sub(fq2_sub(fq2_sqr(lam), rx), ax);
        ry = fq2_sub(fq2_mul(lam, fq2_sub(rx, x3)), ry);
        rx = x3;
        return l;
    };

    int top = 127;
    while (top >= 0 && !((u64)((ATE_LOOP >> top) & 1))) top--;
    for (int i = top - 1; i >= 0; i--) {
        f = fq12_mul(fq12_sqr(f), dbl_step());
        if ((u64)((ATE_LOOP >> i) & 1)) {
            f = fq12_mul(f, add_step(qx, qy));
        }
    }
    // Frobenius endgame: Q1 = psi(Q), nQ2 = -psi^2(Q) on twisted coords:
    // psi(x, y) = (conj(x) gamma^2, conj(y) gamma^3).
    Fq2 q1x = fq2_mul(fq2_conj(qx), FROB_GAMMA[2]);
    Fq2 q1y = fq2_mul(fq2_conj(qy), FROB_GAMMA[3]);
    Fq2 q2x = fq2_mul(fq2_conj(q1x), FROB_GAMMA[2]);
    Fq2 q2y = fq2_neg(fq2_mul(fq2_conj(q1y), FROB_GAMMA[3]));
    f = fq12_mul(f, add_step(q1x, q1y));
    f = fq12_mul(f, add_step(q2x, q2y));
    return f;
}

// final exponent (q^12-1)/r, little-endian u64 limbs (baked constant).
static const u64 FINAL_EXP_LIMBS[44] = {
    0x86964b64ca86f120ULL, 0x40a4efb7e54523a4ULL, 0x837fa97896e84abbULL, 0x361102b6b9b2b918ULL,
    0xc0de81def35692daULL, 0xbe04c7e8a6c3c760ULL, 0xd766f9c9d570bb7fULL, 0xc230974d83561841ULL,
    0x5bba1668c3be69a3ULL, 0x7f3811c410526294ULL, 0x29baee7ddadda71cULL, 0xbf813b8d145da900ULL,
    0x641bbadf423f9a2cULL, 0xa80bb4ea44eacc5eULL, 0xcd65664814fde37cULL, 0x4a0364b9580291d2ULL,
    0xee93dfb10826f0ddULL, 0x6b42db8dc5514724ULL, 0xbb10cf430b0f3785ULL, 0x40494e406f804216ULL,
    0x55cfe107acf3aafbULL, 0x2088ec80e0ebae87ULL, 0x846a3ed011a337a0ULL, 0x48a45a4a1e3a5195ULL,
    0xe5664568dfc50e16ULL, 0xab6a41294c0cc4ebULL, 0x82d0d602d268c7daULL, 0x6668449aed3cc48aULL,
    0x5062cd0fb2015dfcULL, 0x7f2940a8b1ddb3d1ULL, 0x77f5b63a2a226448ULL, 0xfef0781361e443aeULL,
    0xf977870e88d5c6c8ULL, 0x790364a61f676baaULL, 0x5887e72eceaddea3ULL, 0x1377e563a09a1b70ULL,
    0x0c54efee1bd8c3b2ULL, 0x3ec3d15ad524d8f7ULL, 0xdaf15466b2383a5dULL, 0xe1e30a73bb94fec0ULL,
    0x6a1c71015f3f7be2ULL, 0x842d43bf6369b1ffULL, 0x20fddadf107d20bcULL, 0x0000002f4b6dc970ULL};
static const int FINAL_EXP_NLIMBS = 44;

// m^u for the BN parameter u = 4965661367192848881 (63 bits).
static Fq12 fq12_pow_u(const Fq12 &a) {
    const u64 U = 4965661367192848881ULL;
    Fq12 acc = fq12_one();
    Fq12 base = a;
    for (int i = 0; i < 63; i++) {
        if ((U >> i) & 1) acc = fq12_mul(acc, base);
        base = fq12_sqr(base);
    }
    return acc;
}

// Hard part m^((q^4 - q^2 + 1)/r) by the standard BN vectorial addition
// chain (Scott et al.); valid for unitary m (conjugate = inverse), which
// the easy part guarantees.  ~190 squarings + ~100 muls instead of a
// 762-bit generic exponentiation.
static Fq12 final_exp_hard(const Fq12 &m) {
    Fq12 mp = fq12_frob(m);
    Fq12 mp2 = fq12_frob(mp);
    Fq12 mp3 = fq12_frob(mp2);
    Fq12 my = fq12_pow_u(m);
    Fq12 my2 = fq12_pow_u(my);
    Fq12 my3 = fq12_pow_u(my2);
    Fq12 y0 = fq12_mul(fq12_mul(mp, mp2), mp3);
    Fq12 y1 = fq12_conj(m);
    Fq12 y2 = fq12_frob(fq12_frob(my2));
    Fq12 y3 = fq12_conj(fq12_frob(my));
    Fq12 y4 = fq12_conj(fq12_mul(my, fq12_frob(my2)));
    Fq12 y5 = fq12_conj(my2);
    Fq12 y6 = fq12_conj(fq12_mul(my3, fq12_frob(my3)));
    Fq12 T0 = fq12_sqr(y6);
    T0 = fq12_mul(T0, y4);
    T0 = fq12_mul(T0, y5);
    Fq12 T1 = fq12_mul(y3, y5);
    T1 = fq12_mul(T1, T0);
    T0 = fq12_mul(T0, y2);
    T1 = fq12_sqr(T1);
    T1 = fq12_mul(T1, T0);
    T1 = fq12_sqr(T1);
    T0 = fq12_mul(T1, y1);
    T1 = fq12_mul(T1, y0);
    T0 = fq12_sqr(T0);
    T0 = fq12_mul(T0, T1);
    return T0;
}

static Fq12 final_exp(const Fq12 &f) {
    // easy part: f^((q^6-1)(q^2+1)) = (conj(f) * f^-1)^(q^2) * (conj(f)*f^-1)
    Fq12 t = fq12_mul(fq12_conj(f), fq12_inv(f));
    Fq12 t2 = fq12_frob(fq12_frob(t));
    Fq12 m = fq12_mul(t2, t);
    return final_exp_hard(m);
}

// Forward decls (defined with the SRS handle code below).
struct AffinePt;
static G1J pippenger_affine_entry(const uint8_t *points,
                                  const uint8_t *scalars, size_t n);

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

int tnsh_native_version() { return 1; }

// ---- Fr polynomial kernels ----

// Newton interpolation over the domain {0..n-1}; vals/out are n 32-byte
// little-endian Fr elements.  Matches tnsh.poly.interp.interpolate_on_range.
void fr_interp_range(const uint8_t *vals, size_t n, uint8_t *out) {
    if (n == 0) return;
    std::vector<u64> col(n * 4), coeffs(n * 4);
    for (size_t i = 0; i < n; i++) {
        u64 t[4];
        bytes_to_limbs(t, vals + 32 * i);
        to_mont(&col[4 * i], t, FR);
    }
    // inverses of 1..n-1 (Montgomery) by batch inversion
    std::vector<u64> invs(n ? (n) * 4 : 0);
    {
        // prefix products of k = 1..n-1 (Montgomery form of integers)
        std::vector<u64> km((n) * 4), pref((n) * 4);
        u64 acc[4];
        memcpy(acc, FR.one, 32);
        for (size_t k = 1; k < n; k++) {
            u64 kraw[4] = {(u64)k, 0, 0, 0};
            to_mont(&km[4 * k], kraw, FR);
            mmul(acc, acc, &km[4 * k], FR);
            memcpy(&pref[4 * k], acc, 32);
        }
        if (n > 1) {
            u64 inv[4];
            minv(inv, &pref[4 * (n - 1)], FR);
            for (size_t k = n - 1; k >= 1; k--) {
                if (k == 1) {
                    memcpy(&invs[4 * k], inv, 32);
                } else {
                    mmul(&invs[4 * k], inv, &pref[4 * (k - 1)], FR);
                    mmul(inv, inv, &km[4 * k], FR);
                }
            }
        }
    }
    memcpy(&coeffs[0], &col[0], 32);
    size_t len = n;
    for (size_t level = 1; level < n; level++) {
        const u64 *il = &invs[4 * level];
        for (size_t i = 0; i + 1 < len; i++) {
            u64 d[4];
            sub_mod(d, &col[4 * (i + 1)], &col[4 * i], FR);
            mmul(&col[4 * i], d, il, FR);
        }
        len--;
        memcpy(&coeffs[4 * level], &col[0], 32);
    }
    // expand Newton form to monomial coefficients
    std::vector<u64> poly(n * 4, 0);
    memcpy(&poly[0], &coeffs[4 * (n - 1)], 32);
    size_t deg = 0;
    for (size_t kk = n - 1; kk-- > 0;) {
        u64 xk_raw[4] = {(u64)kk, 0, 0, 0};
        u64 xk[4];
        to_mont(xk, xk_raw, FR);
        for (size_t d = deg + 1; d-- > 0;) {
            if (d + 1 <= deg + 1) {
                u64 t[4];
                add_mod(t, &poly[4 * (d + 1)], &poly[4 * d], FR);
                memcpy(&poly[4 * (d + 1)], t, 32);
            }
            u64 t2[4];
            mmul(t2, &poly[4 * d], xk, FR);
            neg_mod(&poly[4 * d], t2, FR);
        }
        deg++;
        u64 t[4];
        add_mod(t, &poly[0], &coeffs[4 * kk], FR);
        memcpy(&poly[0], t, 32);
    }
    for (size_t i = 0; i < n; i++) {
        u64 s[4];
        from_mont(s, &poly[4 * i], FR);
        limbs_to_bytes(out + 32 * i, s);
    }
}

// Horner evaluation of coeffs (n elements) at x.
void fr_horner(const uint8_t *coeffs, size_t n, const uint8_t *x,
               uint8_t *out) {
    u64 xm[4], t[4], acc[4];
    bytes_to_limbs(t, x);
    to_mont(xm, t, FR);
    memset(acc, 0, 32);
    for (size_t i = n; i-- > 0;) {
        u64 c[4], cm[4];
        bytes_to_limbs(c, coeffs + 32 * i);
        to_mont(cm, c, FR);
        mmul(acc, acc, xm, FR);
        add_mod(acc, acc, cm, FR);
    }
    u64 s[4];
    from_mont(s, acc, FR);
    limbs_to_bytes(out, s);
}

// Synthetic division: out (n-1 coeffs) = (P(x) - P(z)) / (x - z).
void fr_quotient(const uint8_t *coeffs, size_t n, const uint8_t *z,
                 uint8_t *out) {
    if (n < 2) return;
    u64 zm[4], t[4];
    bytes_to_limbs(t, z);
    to_mont(zm, t, FR);
    u64 carry[4];
    u64 c[4];
    bytes_to_limbs(c, coeffs + 32 * (n - 1));
    to_mont(carry, c, FR);
    for (size_t i = n - 1; i-- > 0;) {
        u64 s[4];
        from_mont(s, carry, FR);
        limbs_to_bytes(out + 32 * i, s);
        bytes_to_limbs(c, coeffs + 32 * i);
        u64 cm[4];
        to_mont(cm, c, FR);
        mmul(carry, carry, zm, FR);
        add_mod(carry, cm, carry, FR);
    }
}

// Lagrange-at-tau scalars for the evaluation-basis SRS (domain {0..n-1}):
//   L_i(tau) = prod_j (tau - j) / ((tau - i) * (-1)^(n-1-i) * i! * (n-1-i)!)
// One pass of prefix products + a single inversion; replaces the O(n)
// Python Fr loop that dominated commit-time SRS derivation at 2^20.
void fr_lagrange_tau(const uint8_t *tau_b, size_t n, uint8_t *out) {
    if (n == 0) return;
    u64 traw[4], tau[4];
    bytes_to_limbs(traw, tau_b);
    to_mont(tau, traw, FR);
    std::vector<u64> t(4 * n), fact(4 * n), d(4 * n), pref(4 * (n + 1));
    // t_i = tau - i ; fact_k = k!  (both Montgomery, incremental walks)
    u64 cur[4], km[4];
    memcpy(cur, tau, 32);
    memcpy(&fact[0], FR.one, 32);
    memset(km, 0, 32);
    for (size_t i = 0; i < n; i++) {
        memcpy(&t[4 * i], cur, 32);
        sub_mod(cur, cur, FR.one, FR);
        if (i > 0) {
            add_mod(km, km, FR.one, FR);  // km = i (mont)
            mmul(&fact[4 * i], &fact[4 * (i - 1)], km, FR);
        }
    }
    // d_i = (+-) i! (n-1-i)! (tau - i); prefix products for batch inverse
    u64 full[4];
    memcpy(full, FR.one, 32);
    memcpy(&pref[0], FR.one, 32);
    for (size_t i = 0; i < n; i++) {
        u64 den[4];
        mmul(den, &fact[4 * i], &fact[4 * (n - 1 - i)], FR);
        if ((n - 1 - i) % 2 == 1) neg_mod(den, den, FR);
        mmul(&d[4 * i], den, &t[4 * i], FR);
        mmul(&pref[4 * (i + 1)], &pref[4 * i], &d[4 * i], FR);
        mmul(full, full, &t[4 * i], FR);
    }
    u64 inv[4];
    minv(inv, &pref[4 * n], FR);
    for (size_t i = n; i-- > 0;) {
        u64 di_inv[4], s[4], sc[4];
        mmul(di_inv, inv, &pref[4 * i], FR);
        mmul(inv, inv, &d[4 * i], FR);
        mmul(sc, full, di_inv, FR);
        from_mont(s, sc, FR);
        limbs_to_bytes(out + 32 * i, s);
    }
}

// Barycentric evaluation + evaluation-local KZG quotient for open_evals:
//   value = [sum_i v_i * w_i / (z-i)] * prod_i (z-i),   w_i = 1/denom_i
//   q_i   = (value - v_i) / (z - i)
// denom_i = (-1)^(n-1-i) i! (n-1-i)!.  One batch inversion serves both.
void fr_open_evals(const uint8_t *vals, size_t n, const uint8_t *z_b,
                   uint8_t *out_q, uint8_t *out_value) {
    if (n == 0) return;
    u64 zraw[4], z[4];
    bytes_to_limbs(zraw, z_b);
    to_mont(z, zraw, FR);
    std::vector<u64> diff(4 * n), fact(4 * n), den(4 * n), d(4 * n),
        pref(4 * (n + 1)), v(4 * n);
    u64 cur[4], km[4];
    memcpy(cur, z, 32);
    memcpy(&fact[0], FR.one, 32);
    memset(km, 0, 32);
    for (size_t i = 0; i < n; i++) {
        memcpy(&diff[4 * i], cur, 32);  // z - i
        sub_mod(cur, cur, FR.one, FR);
        if (i > 0) {
            add_mod(km, km, FR.one, FR);
            mmul(&fact[4 * i], &fact[4 * (i - 1)], km, FR);
        }
        u64 raw[4];
        bytes_to_limbs(raw, vals + 32 * i);
        to_mont(&v[4 * i], raw, FR);
    }
    u64 full[4];
    memcpy(full, FR.one, 32);
    memcpy(&pref[0], FR.one, 32);
    for (size_t i = 0; i < n; i++) {
        mmul(&den[4 * i], &fact[4 * i], &fact[4 * (n - 1 - i)], FR);
        if ((n - 1 - i) % 2 == 1) neg_mod(&den[4 * i], &den[4 * i], FR);
        mmul(&d[4 * i], &den[4 * i], &diff[4 * i], FR);
        mmul(&pref[4 * (i + 1)], &pref[4 * i], &d[4 * i], FR);
        mmul(full, full, &diff[4 * i], FR);
    }
    u64 inv[4];
    minv(inv, &pref[4 * n], FR);
    // invd_i = 1 / (denom_i * (z - i)); two passes: first accumulate value,
    // then emit quotients (value needed before q_i).
    std::vector<u64> invd(4 * n);
    for (size_t i = n; i-- > 0;) {
        mmul(&invd[4 * i], inv, &pref[4 * i], FR);
        mmul(inv, inv, &d[4 * i], FR);
    }
    u64 acc[4] = {0, 0, 0, 0};
    for (size_t i = 0; i < n; i++) {
        u64 term[4];
        mmul(term, &v[4 * i], &invd[4 * i], FR);
        add_mod(acc, acc, term, FR);
    }
    u64 value[4];
    mmul(value, acc, full, FR);
    u64 vs[4];
    from_mont(vs, value, FR);
    limbs_to_bytes(out_value, vs);
    // q_i = (value - v_i) * invd_i * denom_i
    for (size_t i = 0; i < n; i++) {
        u64 num[4], q[4], s[4];
        sub_mod(num, value, &v[4 * i], FR);
        mmul(q, num, &invd[4 * i], FR);
        mmul(q, q, &den[4 * i], FR);
        from_mont(s, q, FR);
        limbs_to_bytes(out_q + 32 * i, s);
    }
}

// PST multilinear-KZG opening tables: folds the evaluation table along
// the point coordinates, emitting each level's quotient table
// q_i = hi - lo (the PST witness polynomials) in standard form, plus the
// final evaluation.  out_q holds size/2 + size/4 + ... + 1 = size - 1
// elements; backs tnsh.commit.mkzg.MultilinearKZG.open.
void fr_ml_open(const uint8_t *evals, size_t size, const uint8_t *point,
                size_t n_vars, uint8_t *out_q, uint8_t *out_value) {
    std::vector<u64> cur(4 * size);
    // OMP team wake-up costs ~8 ms on this host; only fork when the loop
    // body amortizes it (same rationale for every if() clause below).
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (size >= 65536)
#endif
    for (size_t i = 0; i < size; i++) {
        u64 raw[4];
        bytes_to_limbs(raw, evals + 32 * i);
        to_mont(&cur[4 * i], raw, FR);
    }
    size_t off = 0;
    for (size_t v = 0; v < n_vars; v++) {
        size_t half = size >> (v + 1);
        u64 raw[4], r[4];
        bytes_to_limbs(raw, point + 32 * v);
        to_mont(r, raw, FR);
        std::vector<u64> nxt(4 * half);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (half >= 32768)
#endif
        for (size_t i = 0; i < half; i++) {
            u64 d[4], m[4], s[4];
            sub_mod(d, &cur[8 * i + 4], &cur[8 * i], FR);
            from_mont(s, d, FR);
            limbs_to_bytes(out_q + 32 * (off + i), s);
            mmul(m, r, d, FR);
            add_mod(&nxt[4 * i], &cur[8 * i], m, FR);
        }
        off += half;
        cur.swap(nxt);
    }
    u64 s[4];
    from_mont(s, &cur[0], FR);
    limbs_to_bytes(out_value, s);
}

// ---- sum-of-products sum-check oracle (native-resident tables) ----
//
// Backs tnsh.iop.sumcheck.SumOfProductsOracle for large instances: the
// verifier-enforced sound-mode constraints (tnsh/protocols/sound.py) are
// sums of degree-<=3 products of dense MLE tables; per round the prover
// needs [g(0..3)] = sum over lane pairs of coeff * prod_f (lo + x (hi-lo))
// and then a fold.  Tables live in native memory in Montgomery form; the
// Python side only sees 4 field elements per round.

struct SopTerm {
    u64 coeff[4];  // Montgomery
    std::vector<int> factors;
};

struct SopState {
    size_t size;                       // current table length
    int npts = 4;                      // X-points per round (degree + 1)
    std::vector<std::vector<u64>> tables;  // each 4*size limbs, Montgomery
    std::vector<SopTerm> terms;
    // highest X-point each table is read at during a round (min(term
    // degree, npts-1) over the terms using it): low-degree-only tables
    // (booleanity checks) skip most of the per-pair extension adds
    std::vector<int> need_x;
    std::vector<u64> fold_scratch;  // reused fold target (sop_bind)
    void compute_need() {
        need_x.assign(tables.size(), 1);
        for (const SopTerm &t : terms) {
            int d = (int)t.factors.size();
            if (d > npts - 1) d = npts - 1;
            for (int f : t.factors)
                if (d > need_x[f]) need_x[f] = d;
        }
    }
};

static std::vector<SopState *> g_sop_store;

static bool sop_tab_is_bool(const std::vector<u64> &tab, size_t size) {
    for (size_t i = 0; i < size; i++) {
        const u64 *v = &tab[4 * i];
        if (!is_zero4(v) && memcmp(v, FR.one, 32) != 0) return false;
    }
    return true;
}

// Reuse freed handle slots so long-running provers don't grow the stores
// one pointer per oracle per proof.
extern "C++" {
template <typename T>
static int store_put(std::vector<T *> &store, T *st) {
    for (size_t i = 0; i < store.size(); i++)
        if (!store[i]) {
            store[i] = st;
            return (int)i;
        }
    store.push_back(st);
    return (int)store.size() - 1;
}
}

extern "C" {

// tables: num_tables * size * 32 B standard-form Fr; spec encodes terms as
// a flat int32 stream: [num_factors, f0, f1, ...] per term; coeffs:
// num_terms * 32 B.
int sop_create(const uint8_t *tables, size_t num_tables, size_t size,
               const int32_t *spec, size_t num_terms,
               const uint8_t *coeffs) {
    SopState *st = new SopState();
    st->size = size;
    st->tables.resize(num_tables);
    for (size_t t = 0; t < num_tables; t++) {
        st->tables[t].resize(4 * size);
        const uint8_t *src = tables + t * size * 32;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (size >= 65536)
#endif
        for (size_t i = 0; i < size; i++) {
            u64 raw[4];
            bytes_to_limbs(raw, src + 32 * i);
            to_mont(&st->tables[t][4 * i], raw, FR);
        }
    }
    size_t off = 0;
    for (size_t t = 0; t < num_terms; t++) {
        SopTerm term;
        u64 raw[4];
        bytes_to_limbs(raw, coeffs + 32 * t);
        to_mont(term.coeff, raw, FR);
        int nf = spec[off++];
        for (int f = 0; f < nf; f++) term.factors.push_back(spec[off++]);
        st->terms.push_back(term);
    }
    st->compute_need();
    return store_put(g_sop_store, st);
}

// Forward-difference state for extending a degree-<=d polynomial known at
// f(0..d) to further consecutive integer points with d adds per point.
// Exact field arithmetic — bit-identical to direct evaluation.
// diffs[k] = k-th forward difference anchored at the advancing tail.
static const int FD_MAX = 72;  // npts <= degree+1 <= logK+4, logK <= 48

static inline void fd_init(u64 diffs[][4], const u64 vals[][4], int d) {
    u64 tri[FD_MAX][4];
    for (int i = 0; i <= d; i++) memcpy(tri[i], vals[i], 32);
    memcpy(diffs[0], tri[d], 32);
    for (int k = 1; k <= d; k++) {
        for (int i = d; i >= k; i--)
            sub_mod(tri[i], tri[i], tri[i - 1], FR);
        memcpy(diffs[k], tri[d], 32);
    }
}

static inline void fd_step(u64 diffs[][4], int d) {
    for (int k = d - 1; k >= 0; k--)
        add_mod(diffs[k], diffs[k], diffs[k + 1], FR);
}

// out: npts * 32 B — g(0..npts-1) in standard form.
void sop_round_evals(int id, uint8_t *out) {
    SopState *st = g_sop_store[id];
    size_t half = st->size / 2;
    size_t nt = st->tables.size();
    const int npts = st->npts;
    std::vector<u64> sums(4 * npts, 0);
    size_t maxpairs = 0;
    for (const SopTerm &term : st->terms)
        if (term.factors.size() / 2 > maxpairs)
            maxpairs = term.factors.size() / 2;
#ifdef _OPENMP
#pragma omp parallel if (half >= 4096)
#endif
    {
        std::vector<u64> local(4 * npts, 0);
        std::vector<u64> vals(nt * 4 * npts);  // per table: npts X-points
        std::vector<u64> qbuf(maxpairs * 4 * npts);  // paired-factor quads
        // accumulate-then-extend: per-degree sums of the sub-grid values
        // of low-degree contributions; ONE forward-difference extension
        // per degree per round replaces the per-pair extension (FD is
        // linear over exact field sums — identical values)
        std::vector<u64> dacc(npts * npts * 4, 0);
#ifdef _OPENMP
#pragma omp for schedule(static) nowait
#endif
        for (size_t s = 0; s < half; s++) {
            for (size_t t = 0; t < nt; t++) {
                const u64 *lo = &st->tables[t][8 * s];
                const u64 *hi = lo + 4;
                u64 *v = &vals[4 * npts * t];
                memcpy(&v[0], lo, 32);
                if (npts > 1) memcpy(&v[4], hi, 32);
                u64 d[4];
                sub_mod(d, hi, lo, FR);
                int top = st->need_x.empty() ? npts - 1 : st->need_x[t];
                for (int x = 2; x <= top; x++)
                    add_mod(&v[4 * x], &v[4 * (x - 1)], d, FR);
            }
            // per term: direct products at x <= term degree, then
            // forward-difference extension (d adds/point, not d muls)
            for (const SopTerm &term : st->terms) {
                int d = (int)term.factors.size();
                if (d >= npts) d = npts - 1;
                if ((int)term.factors.size() >= 6 && d == npts - 1) {
                    // paired product tree: adjacent linear factors merge
                    // into quadratics evaluated at X=0..2 and FD-extended
                    // across the grid, so the per-X product costs
                    // ~nf/2 muls instead of nf.  Field multiplication is
                    // exact and associative — identical per-X values.
                    int nf = (int)term.factors.size();
                    int np = nf / 2, odd = nf & 1;
                    for (int i = 0; i < np; i++) {
                        const u64 *fa =
                            &vals[4 * npts * term.factors[2 * i]];
                        const u64 *fb =
                            &vals[4 * npts * term.factors[2 * i + 1]];
                        u64 *q = &qbuf[4 * npts * i];
                        for (int x = 0; x < 3; x++)
                            mmul(&q[4 * x], &fa[4 * x], &fb[4 * x], FR);
                        u64 sl[4], d2[4], t0[4];
                        sub_mod(sl, &q[8], &q[4], FR);      // q2 - q1
                        sub_mod(t0, &q[4], &q[0], FR);      // q1 - q0
                        sub_mod(d2, sl, t0, FR);            // 2nd diff
                        for (int x = 3; x < npts; x++) {
                            add_mod(sl, sl, d2, FR);
                            add_mod(&q[4 * x], &q[4 * (x - 1)], sl, FR);
                        }
                    }
                    const u64 *lastv = odd
                        ? &vals[4 * npts * term.factors[nf - 1]] : nullptr;
                    for (int x = 0; x < npts; x++) {
                        u64 prod[4];
                        memcpy(prod, term.coeff, 32);
                        for (int i = 0; i < np; i++)
                            mmul(prod, prod, &qbuf[4 * (npts * i + x)],
                                 FR);
                        if (lastv) mmul(prod, prod, &lastv[4 * x], FR);
                        add_mod(&local[4 * x], &local[4 * x], prod, FR);
                    }
                    continue;
                }
                if (d + 1 < npts) {
                    // low-degree term: bank the sub-grid values in the
                    // per-degree accumulator; extended once per round
                    u64 *dk = &dacc[4 * npts * d];
                    for (int x = 0; x <= d; x++) {
                        u64 prod[4];
                        memcpy(prod, term.coeff, 32);
                        for (int f : term.factors)
                            mmul(prod, prod, &vals[4 * (npts * f + x)],
                                 FR);
                        add_mod(&dk[4 * x], &dk[4 * x], prod, FR);
                    }
                } else {
                    for (int x = 0; x <= d; x++) {
                        u64 prod[4];
                        memcpy(prod, term.coeff, 32);
                        for (int f : term.factors)
                            mmul(prod, prod, &vals[4 * (npts * f + x)],
                                 FR);
                        add_mod(&local[4 * x], &local[4 * x], prod, FR);
                    }
                }
            }
        }
        // extend each per-degree accumulator across the full X grid
        for (int d = 0; d + 1 < npts; d++) {
            u64 fv[FD_MAX][4];
            bool any = false;
            const u64 *dk = &dacc[4 * npts * d];
            for (int x = 0; x <= d; x++) {
                memcpy(fv[x], &dk[4 * x], 32);
                if (!is_zero4(fv[x])) any = true;
                add_mod(&local[4 * x], &local[4 * x], fv[x], FR);
            }
            if (!any) continue;
            u64 diffs[FD_MAX][4];
            fd_init(diffs, fv, d);
            for (int x = d + 1; x < npts; x++) {
                fd_step(diffs, d);
                add_mod(&local[4 * x], &local[4 * x], diffs[0], FR);
            }
        }
#ifdef _OPENMP
#pragma omp critical
#endif
        for (int x = 0; x < npts; x++)
            add_mod(&sums[4 * x], &sums[4 * x], &local[4 * x], FR);
    }
    for (int x = 0; x < npts; x++) {
        u64 s[4];
        from_mont(s, &sums[4 * x], FR);
        limbs_to_bytes(out + 32 * x, s);
    }
}

void sop_bind(int id, const uint8_t *r_bytes) {
    SopState *st = g_sop_store[id];
    u64 raw[4], r[4];
    bytes_to_limbs(raw, r_bytes);
    to_mont(r, raw, FR);
    size_t half = st->size / 2;
    // Fold into a reused scratch buffer (the in-place variant races
    // under OpenMP: iteration i writes limbs other threads still read);
    // swapping with the scratch avoids an allocation + page-fault pass
    // per table per round.
    if (st->fold_scratch.size() < 4 * half)
        st->fold_scratch.resize(4 * st->size);
    for (auto &tab : st->tables) {
        u64 *out = st->fold_scratch.data();
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (half >= 16384)
#endif
        for (long long i = 0; i < (long long)half; i++) {
            u64 d[4], m[4];
            sub_mod(d, &tab[8 * i + 4], &tab[8 * i], FR);
            mmul(m, r, d, FR);
            add_mod(&out[4 * i], &tab[8 * i], m, FR);
        }
        // ping-pong: the scratch becomes the table, the old table
        // becomes the next fold target (capacity is always sufficient).
        // Shrink once the live data falls well below capacity — holding
        // dozens of full-size buffers through the rest of the prove
        // costs real memory pressure (measured: +2 s on the openings
        // stage at T=2^18 without this).
        tab.swap(st->fold_scratch);
        tab.resize(4 * half);
        if (tab.capacity() > 16 * half) std::vector<u64>(tab).swap(tab);
    }
    st->size = half;
    if (st->fold_scratch.capacity() > 16 * half)
        std::vector<u64>(4 * half).swap(st->fold_scratch);
}

// out: num_terms' final sum = sum_t coeff_t * prod_f T_f[0]  (32 B).
void sop_final(int id, uint8_t *out) {
    SopState *st = g_sop_store[id];
    u64 acc[4] = {0, 0, 0, 0};
    for (const SopTerm &term : st->terms) {
        u64 prod[4];
        memcpy(prod, term.coeff, 32);
        for (int f : term.factors) mmul(prod, prod, &st->tables[f][0], FR);
        add_mod(acc, acc, prod, FR);
    }
    u64 s[4];
    from_mont(s, acc, FR);
    limbs_to_bytes(out, s);
}

void sop_free(int id) {
    if (id >= 0 && id < (int)g_sop_store.size() && g_sop_store[id]) {
        delete g_sop_store[id];
        g_sop_store[id] = nullptr;
    }
}

}  // extern "C"

// ---- sparse (k, j)-cube sum-check oracle: native k-phase ----
//
// Backs tnsh.iop.sparse_oracle.SparseCubeOracle's k rounds (work
// item 2): per round the prover walks every cycle column j, and for each
// term evaluates a product of <=4 linear forms at X = 0..3, pinned to the
// column's sparse residual positions; column-incremental factors (Twist's
// Val) are read from a running prefix state.  Everything lives natively in
// Montgomery form; Python sees 4 field elements per round and, after the
// last k bind, the folded T-sized residues (sco_export) that seed the dense
// j-phase delegate.  Bit-identical to the pure-Python loop (exact field
// arithmetic; addition order is irrelevant).

struct ScoEntry {
    int32_t pos;
    u64 val[4];  // Montgomery
};

struct ScoSparse {
    std::vector<int32_t> off;  // t_size + 1 column offsets
    std::vector<ScoEntry> ent;
};

struct ScoTerm {
    int sp_idx;      // -1: no colsparse factor (class I or E — see below)
    int sp_power;
    std::vector<int> eqk_idx;
    std::vector<int> inc_idx;
};

struct ScoState {
    int log_k, log_t;
    size_t k_rem, t_size;
    std::vector<std::vector<u64>> eqk;      // 4*k_rem limbs, Montgomery
    std::vector<std::vector<u64>> eqj;      // 4*t_size limbs, Montgomery
    std::vector<ScoSparse> sp;
    std::vector<ScoSparse> inc;             // update lists
    std::vector<ScoTerm> terms;
    std::vector<std::vector<int>> eqj_idx;  // per term: eqj factor indices
    std::vector<std::vector<u64>> coeffs;   // per term: 4 limbs, Montgomery
    std::vector<std::vector<u64>> weights;  // per term: 4*t_size, Montgomery
    std::vector<std::vector<u64>> wsum;     // per term: sum_j weights, 4 limbs
    // per inc table: 4*k_rem, the colinc scan's state at this oracle's
    // first column (the deltas of columns held elsewhere); empty = zeros.
    // Set for one round (sco_set_inc_start), cleared by a bind.
    std::vector<std::vector<u64>> inc_start;
};

static std::vector<ScoState *> g_sco_store;

static void sco_parse_csr(std::vector<ScoSparse> &out, const int32_t *offs,
                          const int32_t *pos, const uint8_t *vals,
                          size_t n_tabs, size_t t_size) {
    out.resize(n_tabs);
    for (size_t t = 0; t < n_tabs; t++) {
        const int32_t *off = offs + t * (t_size + 1);
        out[t].off.assign(off, off + t_size + 1);
        int32_t lo = off[0], hi = off[t_size];
        out[t].ent.resize(hi - lo);
        for (int32_t e = lo; e < hi; e++) {
            ScoEntry &E = out[t].ent[e - lo];
            E.pos = pos[e];
            u64 raw[4];
            bytes_to_limbs(raw, vals + 32 * (size_t)e);
            to_mont(E.val, raw, FR);
        }
        if (lo) {  // rebase offsets to this table's entry array
            for (auto &o : out[t].off) o -= lo;
        }
    }
}

extern "C" {

// eqk_blob: n_eqk * 2^log_k * 32 B; eqj_blob: n_eqj * 2^log_t * 32 B.
// Sparse/inc tables arrive as global CSR: per-table offset rows of
// t_size+1 int32 indexing one shared position/value stream.  coeffs:
// n_terms * 32 B.  term_spec flat stream per term:
// [sp_idx, sp_power, n_eqj, j..., n_eqk, e..., n_inc, i...].  Per-column
// term weights (coeff * prod of eqj factors) are computed here, natively.
int sco_create(int log_k, int log_t, const uint8_t *eqk_blob, size_t n_eqk,
               const uint8_t *eqj_blob, size_t n_eqj,
               const int32_t *sp_off, const int32_t *sp_pos,
               const uint8_t *sp_val, size_t n_sp, const int32_t *inc_off,
               const int32_t *inc_pos, const uint8_t *inc_val, size_t n_inc,
               const uint8_t *coeffs, const int32_t *term_spec,
               size_t n_terms) {
    ScoState *st = new ScoState();
    st->log_k = log_k;
    st->log_t = log_t;
    st->k_rem = (size_t)1 << log_k;
    st->t_size = (size_t)1 << log_t;
    st->eqk.resize(n_eqk);
    for (size_t t = 0; t < n_eqk; t++) {
        st->eqk[t].resize(4 * st->k_rem);
        for (size_t i = 0; i < st->k_rem; i++) {
            u64 raw[4];
            bytes_to_limbs(raw, eqk_blob + 32 * (t * st->k_rem + i));
            to_mont(&st->eqk[t][4 * i], raw, FR);
        }
    }
    st->eqj.resize(n_eqj);
    for (size_t t = 0; t < n_eqj; t++) st->eqj[t].resize(4 * st->t_size);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) collapse(2) \
    if (n_eqj * st->t_size >= 65536)
#endif
    for (long long t = 0; t < (long long)n_eqj; t++) {
        for (long long i = 0; i < (long long)st->t_size; i++) {
            u64 raw[4];
            bytes_to_limbs(raw, eqj_blob + 32 * (t * st->t_size + i));
            to_mont(&st->eqj[t][4 * i], raw, FR);
        }
    }
    sco_parse_csr(st->sp, sp_off, sp_pos, sp_val, n_sp, st->t_size);
    sco_parse_csr(st->inc, inc_off, inc_pos, inc_val, n_inc, st->t_size);
    size_t off = 0;
    st->weights.resize(n_terms);
    st->eqj_idx.resize(n_terms);
    st->coeffs.resize(n_terms);
    for (size_t t = 0; t < n_terms; t++) {
        ScoTerm term;
        term.sp_idx = term_spec[off++];
        term.sp_power = term_spec[off++];
        int nj = term_spec[off++];
        for (int i = 0; i < nj; i++)
            st->eqj_idx[t].push_back(term_spec[off++]);
        int ne = term_spec[off++];
        for (int i = 0; i < ne; i++) term.eqk_idx.push_back(term_spec[off++]);
        int ni = term_spec[off++];
        for (int i = 0; i < ni; i++) term.inc_idx.push_back(term_spec[off++]);
        st->terms.push_back(term);
        st->coeffs[t].resize(4);
        u64 raw[4];
        bytes_to_limbs(raw, coeffs + 32 * t);
        to_mont(st->coeffs[t].data(), raw, FR);
        st->weights[t].resize(4 * st->t_size);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1) \
    if (n_terms * st->t_size >= 65536)
#endif
    for (long long t = 0; t < (long long)n_terms; t++) {
        for (size_t j = 0; j < st->t_size; j++) {
            u64 *w = &st->weights[t][4 * j];
            memcpy(w, st->coeffs[t].data(), 32);
            for (int ji : st->eqj_idx[t])
                mmul(w, w, &st->eqj[ji][4 * j], FR);
        }
    }
    st->wsum.resize(n_terms);
    for (size_t t = 0; t < n_terms; t++) {
        st->wsum[t].assign(4, 0);
        for (size_t j = 0; j < st->t_size; j++)
            add_mod(st->wsum[t].data(), st->wsum[t].data(),
                    &st->weights[t][4 * j], FR);
    }
    return store_put(g_sco_store, st);
}

// Multiply v[0..3] (values at X = 0..3) by the linear form (a0, a1) read
// from a pair of adjacent slots: a(X) = a0 + X (a1 - a0).
static inline void sco_mul_linear(u64 v[4][4], const u64 *a0, const u64 *a1) {
    u64 d[4], x2[4], x3[4];
    sub_mod(d, a1, a0, FR);
    add_mod(x2, a1, d, FR);
    add_mod(x3, x2, d, FR);
    mmul(v[0], v[0], a0, FR);
    mmul(v[1], v[1], a1, FR);
    mmul(v[2], v[2], x2, FR);
    mmul(v[3], v[3], x3, FR);
}

// out: 4 * 32 B — the round polynomial evaluations g(0..3), standard form.
// Parallelized over column chunks: the inc scan state is checkpointed at
// chunk starts by a cheap update-only prefix pass, then chunks run
// independently (exact field sums, order-independent).
//
// Term classes (mirrors tnsh/iop/sparse_oracle.py):
//   class S (sp_idx >= 0): per-column sparse entries pin the k position.
//   class I (sp_idx < 0, one colinc): h(X) = sum_rest prod(eqk) * cur is
//     maintained INCREMENTALLY across the scan — O(#eqk) per delta.
//   class E (sp_idx < 0, no colinc): (sum_rest prod eqk)(X) * sum_j w_j.
void sco_round_evals(int id, uint8_t *out) {
    ScoState *st = g_sco_store[id];
    size_t t_size = st->t_size;
    size_t n_inc = st->inc.size();
    size_t nt = st->terms.size();
    size_t half = st->k_rem / 2;
    u64 sums[4][4] = {{0}};

    // class partition: cls_i = class-I term ids; inc2cls[ii] = the class-I
    // terms reading colinc table ii (their h updates ride its deltas)
    std::vector<int> cls_i;
    std::vector<std::vector<int>> inc2cls(n_inc);
    for (size_t t = 0; t < nt; t++) {
        const ScoTerm &term = st->terms[t];
        if (term.sp_idx >= 0) continue;
        if (!term.inc_idx.empty()) {
            inc2cls[term.inc_idx[0]].push_back((int)cls_i.size());
            cls_i.push_back((int)t);
            continue;
        }
        // class E: fully factorized, no column scan
        if (is_zero4(st->wsum[t].data())) continue;
        u64 e[4][4] = {{0}};
        for (size_t rest = 0; rest < half; rest++) {
            u64 p[4][4];
            for (int x = 0; x < 4; x++) memcpy(p[x], FR.one, 32);
            for (int ei : term.eqk_idx)
                sco_mul_linear(p, &st->eqk[ei][8 * rest],
                               &st->eqk[ei][8 * rest + 4]);
            for (int x = 0; x < 4; x++) add_mod(e[x], e[x], p[x], FR);
        }
        for (int x = 0; x < 4; x++) {
            u64 v[4];
            mmul(v, e[x], st->wsum[t].data(), FR);
            add_mod(sums[x], sums[x], v, FR);
        }
    }

    int n_chunks = 1;
#ifdef _OPENMP
    if (t_size >= 16384) {
        n_chunks = omp_get_max_threads();
        if (n_chunks > 16) n_chunks = 16;
        if (n_chunks < 1) n_chunks = 1;
    }
#endif
    size_t chunk = (t_size + n_chunks - 1) / n_chunks;
    std::vector<std::vector<std::vector<u64>>> ckpt(n_chunks);
    {
        std::vector<std::vector<u64>> cur =
            st->inc_start.empty()
                ? std::vector<std::vector<u64>>(
                      n_inc, std::vector<u64>(4 * st->k_rem, 0))
                : st->inc_start;
        for (int c = 0; c < n_chunks; c++) {
            ckpt[c] = cur;
            if (c == n_chunks - 1) break;
            size_t j0 = (size_t)c * chunk, j1 = j0 + chunk;
            for (size_t j = j0; j < j1 && j < t_size; j++) {
                for (size_t ii = 0; ii < n_inc; ii++) {
                    const ScoSparse &U = st->inc[ii];
                    u64 *cu = cur[ii].data();
                    for (int32_t e = U.off[j]; e < U.off[j + 1]; e++) {
                        u64 *slot = cu + 4 * (size_t)U.ent[e].pos;
                        add_mod(slot, slot, U.ent[e].val, FR);
                    }
                }
            }
        }
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n_chunks > 1)
#endif
    for (int c = 0; c < n_chunks; c++) {
        std::vector<std::vector<u64>> cur = ckpt[c];
        u64 local[4][4] = {{0}};
        // class-I running sums, seeded from the chunk-start inc state
        std::vector<std::array<u64, 16>> hst(cls_i.size());
        for (size_t ci = 0; ci < cls_i.size(); ci++) {
            const ScoTerm &term = st->terms[cls_i[ci]];
            u64 h[4][4] = {{0}};
            const u64 *cu = cur[term.inc_idx[0]].data();
            for (size_t rest = 0; rest < half; rest++) {
                const u64 *b0 = cu + 8 * rest;
                const u64 *b1 = b0 + 4;
                if (is_zero4(b0) && is_zero4(b1)) continue;
                u64 v[4][4];
                memcpy(v[0], b0, 32);
                memcpy(v[1], b1, 32);
                u64 d[4];
                sub_mod(d, b1, b0, FR);
                add_mod(v[2], b1, d, FR);
                add_mod(v[3], v[2], d, FR);
                for (int ei : term.eqk_idx)
                    sco_mul_linear(v, &st->eqk[ei][8 * rest],
                                   &st->eqk[ei][8 * rest + 4]);
                for (int x = 0; x < 4; x++) add_mod(h[x], h[x], v[x], FR);
            }
            memcpy(hst[ci].data(), h, 128);
        }
        size_t j0 = (size_t)c * chunk;
        size_t j1 = j0 + chunk < t_size ? j0 + chunk : t_size;
        for (size_t j = j0; j < j1; j++) {
            for (size_t t = 0; t < nt; t++) {
                const ScoTerm &term = st->terms[t];
                if (term.sp_idx < 0) continue;
                const u64 *w = &st->weights[t][4 * j];
                if (is_zero4(w)) continue;
                const ScoSparse &S = st->sp[term.sp_idx];
                int32_t e0 = S.off[j], e1 = S.off[j + 1];
                if (term.sp_power == 2 && e1 - e0 > 1) {
                    // merge same-pair entries BEFORE squaring: a pair's
                    // restriction is ONE linear form, (a+b)^2 != a^2+b^2
                    struct PF {
                        int32_t rest;
                        u64 lo[4], hi[4];
                    };
                    std::vector<PF> pf;
                    for (int32_t e = e0; e < e1; e++) {
                        int32_t p = S.ent[e].pos;
                        int32_t rest = p >> 1;
                        PF *f = nullptr;
                        for (auto &q : pf)
                            if (q.rest == rest) {
                                f = &q;
                                break;
                            }
                        if (!f) {
                            pf.push_back(PF());
                            f = &pf.back();
                            f->rest = rest;
                            memset(f->lo, 0, 32);
                            memset(f->hi, 0, 32);
                        }
                        u64 *slot = (p & 1) ? f->hi : f->lo;
                        add_mod(slot, slot, S.ent[e].val, FR);
                    }
                    for (const auto &f : pf) {
                        size_t rest = (size_t)f.rest * 8;
                        u64 v[4][4], d[4];
                        memcpy(v[0], f.lo, 32);
                        memcpy(v[1], f.hi, 32);
                        sub_mod(d, f.hi, f.lo, FR);
                        add_mod(v[2], f.hi, d, FR);
                        add_mod(v[3], v[2], d, FR);
                        for (int x = 0; x < 4; x++) msq(v[x], v[x], FR);
                        for (int x = 0; x < 4; x++) mmul(v[x], v[x], w, FR);
                        for (int ei : term.eqk_idx)
                            sco_mul_linear(v, &st->eqk[ei][rest],
                                           &st->eqk[ei][rest + 4]);
                        for (int ii : term.inc_idx)
                            sco_mul_linear(v, &cur[ii][rest],
                                           &cur[ii][rest + 4]);
                        for (int x = 0; x < 4; x++)
                            add_mod(local[x], local[x], v[x], FR);
                    }
                    continue;
                }
                for (int32_t e = e0; e < e1; e++) {
                    int32_t p = S.ent[e].pos;
                    const u64 *cv = S.ent[e].val;
                    size_t rest = (size_t)(p >> 1) * 8;  // pair limb offset
                    u64 v[4][4];
                    if (p & 1) {  // (0, c, 2c, 3c)
                        memset(v[0], 0, 32);
                        memcpy(v[1], cv, 32);
                        add_mod(v[2], cv, cv, FR);
                        add_mod(v[3], v[2], cv, FR);
                    } else {  // (c, 0, -c, -2c)
                        memcpy(v[0], cv, 32);
                        memset(v[1], 0, 32);
                        neg_mod(v[2], cv, FR);
                        add_mod(v[3], v[2], v[2], FR);
                    }
                    if (term.sp_power == 2)
                        for (int x = 0; x < 4; x++) msq(v[x], v[x], FR);
                    for (int x = 0; x < 4; x++) mmul(v[x], v[x], w, FR);
                    for (int ei : term.eqk_idx)
                        sco_mul_linear(v, &st->eqk[ei][rest],
                                       &st->eqk[ei][rest + 4]);
                    for (int ii : term.inc_idx)
                        sco_mul_linear(v, &cur[ii][rest],
                                       &cur[ii][rest + 4]);
                    for (int x = 0; x < 4; x++)
                        add_mod(local[x], local[x], v[x], FR);
                }
            }
            // class-I contributions read h BEFORE column j's updates
            for (size_t ci = 0; ci < cls_i.size(); ci++) {
                const u64 *w = &st->weights[cls_i[ci]][4 * j];
                if (is_zero4(w)) continue;
                for (int x = 0; x < 4; x++) {
                    u64 v[4];
                    mmul(v, w, hst[ci].data() + 4 * x, FR);
                    add_mod(local[x], local[x], v, FR);
                }
            }
            for (size_t ii = 0; ii < n_inc; ii++) {
                const ScoSparse &U = st->inc[ii];
                u64 *cu = cur[ii].data();
                for (int32_t e = U.off[j]; e < U.off[j + 1]; e++) {
                    int32_t p = U.ent[e].pos;
                    const u64 *dv = U.ent[e].val;
                    u64 *slot = cu + 4 * (size_t)p;
                    add_mod(slot, slot, dv, FR);
                    size_t rest = (size_t)(p >> 1) * 8;
                    for (int ci : inc2cls[ii]) {
                        const ScoTerm &term = st->terms[cls_i[ci]];
                        u64 v[4][4];
                        if (p & 1) {  // delta * X
                            memset(v[0], 0, 32);
                            memcpy(v[1], dv, 32);
                            add_mod(v[2], dv, dv, FR);
                            add_mod(v[3], v[2], dv, FR);
                        } else {  // delta * (1 - X)
                            memcpy(v[0], dv, 32);
                            memset(v[1], 0, 32);
                            neg_mod(v[2], dv, FR);
                            add_mod(v[3], v[2], v[2], FR);
                        }
                        for (int ei : term.eqk_idx)
                            sco_mul_linear(v, &st->eqk[ei][rest],
                                           &st->eqk[ei][rest + 4]);
                        u64 *h = hst[ci].data();
                        for (int x = 0; x < 4; x++)
                            add_mod(h + 4 * x, h + 4 * x, v[x], FR);
                    }
                }
            }
        }
#ifdef _OPENMP
#pragma omp critical
#endif
        for (int x = 0; x < 4; x++) add_mod(sums[x], sums[x], local[x], FR);
    }
    for (int x = 0; x < 4; x++) {
        u64 s[4];
        from_mont(s, sums[x], FR);
        limbs_to_bytes(out + 32 * x, s);
    }
}

static void sco_fold_sparse(ScoSparse &S, const u64 r[4], const u64 nr[4],
                            size_t t_size) {
    std::vector<int32_t> noff(t_size + 1);
    std::vector<ScoEntry> nent;
    nent.reserve(S.ent.size());
    noff[0] = 0;
    for (size_t j = 0; j < t_size; j++) {
        size_t start = nent.size();
        for (int32_t e = S.off[j]; e < S.off[j + 1]; e++) {
            int32_t np = S.ent[e].pos >> 1;
            u64 w[4];
            mmul(w, S.ent[e].val, (S.ent[e].pos & 1) ? r : nr, FR);
            bool merged = false;
            for (size_t q = start; q < nent.size(); q++) {
                if (nent[q].pos == np) {
                    add_mod(nent[q].val, nent[q].val, w, FR);
                    merged = true;
                    break;
                }
            }
            if (!merged) {
                ScoEntry ne;
                ne.pos = np;
                memcpy(ne.val, w, 32);
                nent.push_back(ne);
            }
        }
        noff[j + 1] = (int32_t)nent.size();
    }
    S.off.swap(noff);
    S.ent.swap(nent);
}

void sco_bind(int id, const uint8_t *r_bytes) {
    ScoState *st = g_sco_store[id];
    u64 raw[4], r[4], nr[4];
    bytes_to_limbs(raw, r_bytes);
    to_mont(r, raw, FR);
    sub_mod(nr, FR.one, r, FR);
    size_t half = st->k_rem / 2;
    for (auto &tab : st->eqk) {
        std::vector<u64> nxt(4 * half);
        for (size_t i = 0; i < half; i++) {
            u64 d[4], m[4];
            sub_mod(d, &tab[8 * i + 4], &tab[8 * i], FR);
            mmul(m, r, d, FR);
            add_mod(&nxt[4 * i], &tab[8 * i], m, FR);
        }
        tab.swap(nxt);
    }
    for (auto &S : st->sp) sco_fold_sparse(S, r, nr, st->t_size);
    for (auto &U : st->inc) sco_fold_sparse(U, r, nr, st->t_size);
    st->k_rem = half;
    st->inc_start.clear();  // stale after a fold
}

// Seed the next round's colinc scan (and so its class-I running sums):
// blob holds n_inc * k_rem standard-form values, per inc table the state
// of the columns that precede this oracle's first one (a column-sharded
// mesh: the lower ranks' delta totals).  n_inc = 0 clears the seed.
void sco_set_inc_start(int id, const uint8_t *blob, size_t n_inc) {
    ScoState *st = g_sco_store[id];
    st->inc_start.assign(n_inc, std::vector<u64>(4 * st->k_rem));
    for (size_t ii = 0; ii < n_inc; ii++) {
        for (size_t i = 0; i < st->k_rem; i++) {
            u64 raw[4];
            bytes_to_limbs(raw, blob + 32 * (ii * st->k_rem + i));
            to_mont(&st->inc_start[ii][4 * i], raw, FR);
        }
    }
}

// out: per inc table, k_rem standard-form values: the sum of its deltas at
// each residual position of the current fold level (what this oracle's
// columns add to the scan state of the columns after them).
void sco_inc_totals(int id, uint8_t *out) {
    ScoState *st = g_sco_store[id];
    for (size_t ii = 0; ii < st->inc.size(); ii++) {
        const ScoSparse &U = st->inc[ii];
        std::vector<u64> tot(4 * st->k_rem, 0);
        for (const ScoEntry &e : U.ent) {
            u64 *slot = &tot[4 * (size_t)e.pos];
            add_mod(slot, slot, e.val, FR);
        }
        for (size_t i = 0; i < st->k_rem; i++) {
            u64 s[4];
            from_mont(s, &tot[4 * i], FR);
            limbs_to_bytes(out + 32 * (ii * st->k_rem + i), s);
        }
    }
}

// After the k binds: build the dense j-phase delegate's SopState directly
// from the folded native state (zero Python round-trips).  Table order:
// eqj tables, then per sparse table its T column sums, then per inc table
// its T-entry prefix table; term coefficients absorb the fully-folded eqk
// scalars.  Returns a sop handle usable with sop_round_evals/bind/final.
int sco_make_sop(int id) {
    ScoState *st = g_sco_store[id];
    size_t t_size = st->t_size;
    SopState *so = new SopState();
    so->size = t_size;
    size_t n_eqj = st->eqj.size(), n_sp = st->sp.size();
    so->tables.reserve(n_eqj + n_sp + st->inc.size());
    for (const auto &t : st->eqj) so->tables.push_back(t);
    for (const auto &S : st->sp) {
        std::vector<u64> tab(4 * t_size, 0);
        for (size_t j = 0; j < t_size; j++)
            for (int32_t e = S.off[j]; e < S.off[j + 1]; e++)
                add_mod(&tab[4 * j], &tab[4 * j], S.ent[e].val, FR);
        so->tables.push_back(std::move(tab));
    }
    for (const auto &U : st->inc) {
        std::vector<u64> tab(4 * t_size);
        u64 cur[4] = {0, 0, 0, 0};
        for (size_t j = 0; j < t_size; j++) {
            memcpy(&tab[4 * j], cur, 32);
            for (int32_t e = U.off[j]; e < U.off[j + 1]; e++)
                add_mod(cur, cur, U.ent[e].val, FR);
        }
        so->tables.push_back(std::move(tab));
    }
    for (size_t t = 0; t < st->terms.size(); t++) {
        const ScoTerm &term = st->terms[t];
        SopTerm so_t;
        memcpy(so_t.coeff, st->coeffs[t].data(), 32);
        for (int ei : term.eqk_idx)
            mmul(so_t.coeff, so_t.coeff, &st->eqk[ei][0], FR);
        for (int ji : st->eqj_idx[t]) so_t.factors.push_back(ji);
        for (int x = 0; x < term.sp_power; x++)
            so_t.factors.push_back((int)n_eqj + term.sp_idx);
        for (int ii : term.inc_idx)
            so_t.factors.push_back((int)(n_eqj + n_sp) + ii);
        so->terms.push_back(so_t);
    }
    so->compute_need();
    return store_put(g_sop_store, so);
}

void sco_free(int id) {
    if (id >= 0 && id < (int)g_sco_store.size() && g_sco_store[id]) {
        delete g_sco_store[id];
        g_sco_store[id] = nullptr;
    }
}

// ---- witness-table kernels (CSR column tables) -----------------------------
// One CSR table: off[t_size+1], pos[nnz], val[nnz*32 B standard form].
// inc_mode: 0 = column-sparse (entries ARE column j), 1 = column-incremental
// (entries are deltas applied AFTER column j; column 0 starts zero).
// These replace the per-prove Python loops building commit scalars,
// k-residues, and MLE evaluations for the sound provers.

static void wt_load_mont(std::vector<u64> &out, const uint8_t *in, size_t n) {
    out.resize(4 * n);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 16384)
#endif
    for (long long i = 0; i < (long long)n; i++) {
        u64 raw[4];
        bytes_to_limbs(raw, in + 32 * i);
        to_mont(&out[4 * i], raw, FR);
    }
}

extern "C" {

// acc: 4*t_size u64 Montgomery accumulator (caller-zeroed; export with
// wt_export_std) — acc[j] += coeff * s_j where s_j = <column_j, eqk>
// (inc_mode 0) or the prefix state before column j's deltas (inc_mode 1).
// Accumulation lets the RLC batch opener fold several tables into ONE
// scalar vector without Python bigint work.
void wt_col_scalars(const int32_t *off, const int32_t *pos,
                    const uint8_t *valb, long long t_size,
                    const uint8_t *eqkb, long long k_size, int inc_mode,
                    const uint8_t *coeffb, u64 *acc) {
    std::vector<u64> eqk;
    wt_load_mont(eqk, eqkb, (size_t)k_size);
    u64 coeff[4], raw[4];
    bytes_to_limbs(raw, coeffb);
    to_mont(coeff, raw, FR);
    u64 cur[4] = {0, 0, 0, 0};
    for (long long j = 0; j < t_size; j++) {
        u64 sj[4];
        if (inc_mode)
            memcpy(sj, cur, 32);  // column value = state BEFORE j's deltas
        else
            memset(sj, 0, 32);
        for (int32_t e = off[j]; e < off[j + 1]; e++) {
            u64 v[4], w[4];
            bytes_to_limbs(raw, valb + 32 * (size_t)e);
            to_mont(v, raw, FR);
            mmul(w, v, &eqk[4 * (size_t)pos[e]], FR);
            if (inc_mode)
                add_mod(cur, cur, w, FR);
            else
                add_mod(sj, sj, w, FR);
        }
        u64 here[4];
        mmul(here, sj, coeff, FR);
        add_mod(&acc[4 * j], &acc[4 * j], here, FR);
    }
}

// acc: 4*k_size u64 Montgomery accumulator — acc[k] += coeff * g[k] with
// g[k] = sum_j w_j column_j(k); w_j = eqw[j] (inc_mode 0) or the STRICT
// SUFFIX sum of eqw past j (inc_mode 1: a delta at cycle j is visible
// from cycle j+1 on).
void wt_residue(const int32_t *off, const int32_t *pos, const uint8_t *valb,
                long long t_size, const uint8_t *eqwb, long long k_size,
                int inc_mode, const uint8_t *coeffb, u64 *acc) {
    std::vector<u64> eqw;
    wt_load_mont(eqw, eqwb, (size_t)t_size);
    u64 coeff[4], raw[4];
    bytes_to_limbs(raw, coeffb);
    to_mont(coeff, raw, FR);
    std::vector<u64> w(4 * t_size);
    if (inc_mode) {
        u64 suf[4] = {0, 0, 0, 0};
        for (long long j = t_size - 1; j >= 0; j--) {
            memcpy(&w[4 * j], suf, 32);
            add_mod(suf, suf, &eqw[4 * j], FR);
        }
    } else {
        w.assign(eqw.begin(), eqw.end());
    }
    for (long long j = 0; j < t_size; j++) {
        u64 *wj = &w[4 * j];
        if (is_zero4(wj)) continue;
        u64 wc[4];
        mmul(wc, wj, coeff, FR);
        for (int32_t e = off[j]; e < off[j + 1]; e++) {
            u64 v[4], m[4];
            bytes_to_limbs(raw, valb + 32 * (size_t)e);
            to_mont(v, raw, FR);
            mmul(m, v, wc, FR);
            u64 *slot = &acc[4 * (size_t)pos[e]];
            add_mod(slot, slot, m, FR);
        }
    }
}

// Export a Montgomery u64 accumulator as n * 32 B standard-form words.
void wt_export_std(const u64 *acc, long long n, uint8_t *out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 16384)
#endif
    for (long long i = 0; i < n; i++) {
        u64 s[4];
        from_mont(s, &acc[4 * i], FR);
        limbs_to_bytes(out + 32 * i, s);
    }
}

// out: 32 B — ~table(point) = sum_j eqj[j] * <column_j, eqk>.
void wt_mle(const int32_t *off, const int32_t *pos, const uint8_t *valb,
            long long t_size, const uint8_t *eqkb, long long k_size,
            const uint8_t *eqjb, int inc_mode, uint8_t *out) {
    std::vector<u64> eqk, eqj;
    wt_load_mont(eqk, eqkb, (size_t)k_size);
    wt_load_mont(eqj, eqjb, (size_t)t_size);
    u64 acc[4] = {0, 0, 0, 0};
    u64 cur[4] = {0, 0, 0, 0};
    for (long long j = 0; j < t_size; j++) {
        if (inc_mode) {
            u64 m[4];
            mmul(m, &eqj[4 * j], cur, FR);
            add_mod(acc, acc, m, FR);
        }
        for (int32_t e = off[j]; e < off[j + 1]; e++) {
            u64 raw[4], v[4], w[4];
            bytes_to_limbs(raw, valb + 32 * (size_t)e);
            to_mont(v, raw, FR);
            mmul(w, v, &eqk[4 * (size_t)pos[e]], FR);
            if (inc_mode) {
                add_mod(cur, cur, w, FR);
            } else {
                u64 m[4];
                mmul(m, w, &eqj[4 * j], FR);
                add_mod(acc, acc, m, FR);
            }
        }
    }
    u64 s[4];
    from_mont(s, acc, FR);
    limbs_to_bytes(out, s);
}

}  // extern "C"

// ---- eq / lt evaluation tables ---------------------------------------------
// Same values as tnsh/poly/eq.py (exact field arithmetic, little-endian bit
// order); built in Montgomery form with one from_mont pass at the end.  The
// Python builders cost seconds at T = 2^18+ (2*T bigint muls + 32 B/elem
// marshalling) and these tables front every sound-mode sum-check term.

// point: n_vars * 32 B standard-form Fr.  out: 2^n_vars * 32 B standard.
void fr_eq_table(const uint8_t *point, int n_vars, uint8_t *out) {
    size_t size = (size_t)1 << n_vars;
    std::vector<u64> tab(4 * size);
    memcpy(tab.data(), FR.one, 32);
    size_t cur = 1;
    for (int i = 0; i < n_vars; i++) {
        u64 raw[4], t[4], nt[4];
        bytes_to_limbs(raw, point + 32 * (size_t)i);
        to_mont(t, raw, FR);
        sub_mod(nt, FR.one, t, FR);
        // new bit joins as the SLOWEST index bit: high half = v*t,
        // low half = v*(1-t); descending j keeps the in-place write safe
        for (size_t j = cur; j-- > 0;) {
            u64 *lo = &tab[4 * j];
            mmul(&tab[4 * (cur + j)], lo, t, FR);
            mmul(lo, lo, nt, FR);
        }
        cur <<= 1;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (size >= 16384)
#endif
    for (long long j = 0; j < (long long)size; j++) {
        u64 s[4];
        from_mont(s, &tab[4 * j], FR);
        limbs_to_bytes(out + 32 * j, s);
    }
}

// [lt~(bits(j), y)] via the top-bit recursion: adding bit i as the new
// slowest index bit, lt(j + b*2^i) = (1-b)*y_i + eq(b, y_i)*lt(j) and
// eq(j + b*2^i) = eq(b, y_i)*eq(j) — identical values to the Python
// MSB-down construction in tnsh/poly/eq.py.
void fr_lt_table(const uint8_t *y, int n_vars, uint8_t *out) {
    size_t size = (size_t)1 << n_vars;
    std::vector<u64> lt(4 * size, 0), eq(4 * size);
    memcpy(eq.data(), FR.one, 32);
    size_t cur = 1;
    for (int i = 0; i < n_vars; i++) {
        u64 raw[4], t[4], nt[4];
        bytes_to_limbs(raw, y + 32 * (size_t)i);
        to_mont(t, raw, FR);
        sub_mod(nt, FR.one, t, FR);
        for (size_t j = cur; j-- > 0;) {
            u64 *lo_lt = &lt[4 * j];
            u64 *lo_eq = &eq[4 * j];
            u64 *hi_lt = &lt[4 * (cur + j)];
            u64 *hi_eq = &eq[4 * (cur + j)];
            // b = 1: lt' = y_i * lt ; eq' = y_i * eq
            mmul(hi_lt, lo_lt, t, FR);
            mmul(hi_eq, lo_eq, t, FR);
            // b = 0: lt' = y_i + (1-y_i) * lt ; eq' = (1-y_i) * eq
            mmul(lo_lt, lo_lt, nt, FR);
            add_mod(lo_lt, lo_lt, t, FR);
            mmul(lo_eq, lo_eq, nt, FR);
        }
        cur <<= 1;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (size >= 16384)
#endif
    for (long long j = 0; j < (long long)size; j++) {
        u64 s[4];
        from_mont(s, &lt[4 * j], FR);
        limbs_to_bytes(out + 32 * j, s);
    }
}

}  // extern "C"

// ---- G1 ----

extern "C" void g1_scalar_mul_c(const uint8_t *point, const uint8_t *scalar,
                                uint8_t *out);

void g1_scalar_mul_c(const uint8_t *point, const uint8_t *scalar,
                     uint8_t *out) {
    G1J p = g1_from_bytes(point);
    u64 k[4];
    bytes_to_limbs(k, scalar);
    g1_to_bytes(out, g1_scalar_mul_j(p, k));
}

void g1_add_c(const uint8_t *a, const uint8_t *b, uint8_t *out) {
    g1_to_bytes(out, g1_add(g1_from_bytes(a), g1_from_bytes(b)));
}

// Pippenger MSM over n (point, scalar) pairs.  Points arrive in standard
// affine bytes; they are batch-normalized once and fed to the shared
// GLV/signed-digit Pippenger core.
void g1_msm(const uint8_t *points, const uint8_t *scalars, size_t n,
            uint8_t *out) {
    g1_to_bytes(out, pippenger_affine_entry(points, scalars, n));
}

// n scalar muls of a SHARED base with a shared window table
// (fixed-base batch: used for powers-of-tau setup).
void g1_fixed_base_batch(const uint8_t *base, const uint8_t *scalars, size_t n,
                         uint8_t *out) {
    G1J b = g1_from_bytes(base);
    if (n < 8) {
        // Table amortization doesn't pay below a handful of scalars.
        for (size_t i = 0; i < n; i++) {
            u64 k[4];
            bytes_to_limbs(k, scalars + 32 * i);
            g1_to_bytes(out + 64 * i, g1_scalar_mul_j(b, k));
        }
        return;
    }
    // Window width minimizing table-build + per-scalar add counts:
    // ceil(256/w) windows cost (2^w - 2) builds each and one add per
    // scalar per window.
    int wbits = 2;
    double best = 1e300;
    for (int cand = 2; cand <= 8; cand++) {
        int W = (256 + cand - 1) / cand;
        double cost =
            (double)W * (double)((1 << cand) - 2) + (double)n * (double)W;
        if (cost < best) {
            best = cost;
            wbits = cand;
        }
    }
    const int W = (256 + wbits - 1) / wbits, D = 1 << wbits;
    // table[w][d] = d * 2^(wbits*w) * base
    std::vector<G1J> table((size_t)W * D);
    G1J wb = b;
    for (int w = 0; w < W; w++) {
        table[(size_t)w * D] = g1_zero();
        table[(size_t)w * D + 1] = wb;
        for (int d = 2; d < D; d++)
            table[(size_t)w * D + d] = g1_add(table[(size_t)w * D + d - 1], wb);
        for (int k = 0; k < wbits; k++) wb = g1_dbl(wb);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 1024)
#endif
    for (size_t i = 0; i < n; i++) {
        u64 k[4];
        bytes_to_limbs(k, scalars + 32 * i);
        G1J acc = g1_zero();
        for (int w = 0; w < W; w++) {
            int shift = w * wbits;
            int limb = shift / 64, off = shift % 64;
            u64 d = (limb < 4) ? (k[limb] >> off) : 0;
            if (off + wbits > 64 && limb + 1 < 4) d |= k[limb + 1] << (64 - off);
            d &= (u64)(D - 1);
            if (d) acc = g1_add(acc, table[(size_t)w * D + (size_t)d]);
        }
        g1_to_bytes(out + 64 * i, acc);
    }
}

// ---- G2 ----

void g2_scalar_mul_c(const uint8_t *point, const uint8_t *scalar,
                     uint8_t *out) {
    G2J p = g2_from_bytes(point);
    u64 k[4];
    bytes_to_limbs(k, scalar);
    g2_to_bytes(out, g2_scalar_mul_j(p, k));
}

void g2_add_c(const uint8_t *a, const uint8_t *b, uint8_t *out) {
    g2_to_bytes(out, g2_add(g2_from_bytes(a), g2_from_bytes(b)));
}

void g2_neg_c(const uint8_t *a, uint8_t *out) {
    G2J p = g2_from_bytes(a);
    p.Y = fq2_neg(p.Y);
    g2_to_bytes(out, p);
}

// ---- pairing ----

// Returns 1 iff e(a1, a2) == e(b1, b2); points affine standard bytes.
// Computed as e(a1, a2) * e(-b1, b2) == 1 with a single final exponentiation.
int pairing_equal(const uint8_t *a1, const uint8_t *a2, const uint8_t *b1,
                  const uint8_t *b2) {
    G1J A1 = g1_from_bytes(a1);
    G1J B1 = g1_from_bytes(b1);
    G2J A2 = g2_from_bytes(a2);
    G2J B2 = g2_from_bytes(b2);
    Fq12 f = fq12_one();
    if (!g1_is_zero(A1) && !g2_is_zero(A2)) {
        u64 px[4], py[4];
        g1_to_affine(A1, px, py);
        Fq2 qx, qy;
        g2_to_affine(A2, qx, qy);
        f = fq12_mul(f, miller_loop(qx, qy, px, py));
    }
    if (!g1_is_zero(B1) && !g2_is_zero(B2)) {
        u64 px[4], py[4];
        u64 ny[4];
        neg_mod(ny, B1.Y, FQ);  // negate B1
        memcpy(B1.Y, ny, 32);
        g1_to_affine(B1, px, py);
        Fq2 qx, qy;
        g2_to_affine(B2, qx, qy);
        f = fq12_mul(f, miller_loop(qx, qy, px, py));
    }
    Fq12 e = final_exp(f);
    return fq12_eq(e, fq12_one()) ? 1 : 0;
}

// Product check: prod_i e(P_i, Q_i) == 1 over n pairs.
int pairing_product_is_one_c(const uint8_t *g1s, const uint8_t *g2s,
                             size_t n) {
    Fq12 f = fq12_one();
    for (size_t i = 0; i < n; i++) {
        G1J P = g1_from_bytes(g1s + 64 * i);
        G2J Q = g2_from_bytes(g2s + 128 * i);
        if (g1_is_zero(P) || g2_is_zero(Q)) continue;
        u64 px[4], py[4];
        g1_to_affine(P, px, py);
        Fq2 qx, qy;
        g2_to_affine(Q, qx, qy);
        f = fq12_mul(f, miller_loop(qx, qy, px, py));
    }
    return fq12_eq(final_exp(f), fq12_one()) ? 1 : 0;
}

}  // extern "C" (main ABI)

// ---- SRS handles: large point sets resident in native memory ----
//
// At 2^20+ SRS sizes, materializing Python point objects costs GBs; these
// handles keep affine Montgomery coordinates in C++ vectors and run MSMs
// (mixed-add Pippenger, OpenMP over windows) directly against them.

struct AffinePt {
    u64 x[4], y[4];
    bool inf;
};

static std::vector<std::vector<AffinePt>> g_srs_store;

// Mixed add: q affine (Z = 1).  ~30% fewer muls than the general add.
static G1J g1_add_mixed(const G1J &p, const AffinePt &q) {
    if (q.inf) return p;
    if (g1_is_zero(p)) {
        G1J r;
        memcpy(r.X, q.x, 32);
        memcpy(r.Y, q.y, 32);
        memcpy(r.Z, FQ.one, 32);
        return r;
    }
    u64 Z1Z1[4], U2[4], S2[4], H[4], HH[4], I[4], J[4], rr[4], V[4], t[4],
        X3[4], Y3[4], Z3[4];
    msq(Z1Z1, p.Z, FQ);
    mmul(U2, q.x, Z1Z1, FQ);
    mmul(S2, q.y, p.Z, FQ);
    mmul(S2, S2, Z1Z1, FQ);
    sub_mod(H, U2, p.X, FQ);
    sub_mod(rr, S2, p.Y, FQ);
    if (is_zero4(H)) {
        if (is_zero4(rr)) return g1_dbl(p);
        return g1_zero();
    }
    add_mod(rr, rr, rr, FQ);
    add_mod(t, H, H, FQ);
    msq(I, t, FQ);
    mmul(J, H, I, FQ);
    mmul(V, p.X, I, FQ);
    msq(X3, rr, FQ);
    sub_mod(X3, X3, J, FQ);
    add_mod(t, V, V, FQ);
    sub_mod(X3, X3, t, FQ);
    sub_mod(t, V, X3, FQ);
    mmul(Y3, rr, t, FQ);
    mmul(t, p.Y, J, FQ);
    add_mod(t, t, t, FQ);
    sub_mod(Y3, Y3, t, FQ);
    mmul(Z3, p.Z, H, FQ);
    add_mod(Z3, Z3, Z3, FQ);
    G1J r;
    memcpy(r.X, X3, 32);
    memcpy(r.Y, Y3, 32);
    memcpy(r.Z, Z3, 32);
    return r;
}

// Batch-convert Jacobian points to affine Montgomery with one inversion.
static void g1_batch_to_affine(const std::vector<G1J> &pts,
                               std::vector<AffinePt> &out) {
    size_t n = pts.size();
    out.resize(n);
    std::vector<u64> prefix(4 * (n + 1));
    memcpy(&prefix[0], FQ.one, 32);
    for (size_t i = 0; i < n; i++) {
        if (g1_is_zero(pts[i])) {
            memcpy(&prefix[4 * (i + 1)], &prefix[4 * i], 32);
        } else {
            mmul(&prefix[4 * (i + 1)], &prefix[4 * i], pts[i].Z, FQ);
        }
    }
    u64 inv[4];
    minv(inv, &prefix[4 * n], FQ);
    for (size_t i = n; i-- > 0;) {
        if (g1_is_zero(pts[i])) {
            out[i].inf = true;
            memset(out[i].x, 0, 32);
            memset(out[i].y, 0, 32);
            continue;
        }
        u64 zinv[4], zinv2[4];
        mmul(zinv, inv, &prefix[4 * i], FQ);
        mmul(inv, inv, pts[i].Z, FQ);
        msq(zinv2, zinv, FQ);
        out[i].inf = false;
        mmul(out[i].x, pts[i].X, zinv2, FQ);
        mmul(out[i].y, pts[i].Y, zinv2, FQ);
        mmul(out[i].y, out[i].y, zinv, FQ);
    }
}

// ---------------------------------------------------------------------------
// GLV endomorphism + signed-digit windows for the MSM hot path.
//
// BN254 G1 has the efficiently computable endomorphism phi(x,y)=(beta*x, y)
// acting as scalar multiplication by lambda (a primitive cube root of unity
// mod r).  Babai rounding on a precomputed short lattice basis splits each
// 254-bit scalar into k = k1 + lambda*k2 with |k1|,|k2| < 2^127 (verified
// over 2e5 random scalars), halving the window count; signed-digit recoding
// halves the bucket count, buying one extra window bit for free.  This is
// the classic ~1.7-1.9x Pippenger speedup the reference's per-term
// scalar-mul MSM (commitments.rs:173-177) leaves on the table.
// ---------------------------------------------------------------------------

// beta (standard form) — cube root of unity in Fq matching lambda.
static const u64 GLV_BETA_STD[4] = {0x5763473177fffffeULL, 0xd4f263f1acdb5c4fULL,
                                    0x59e26bcea0d48bacULL, 0ULL};
// short basis v1 = (A1, -B1N), v2 = (A2, B2); det = r.
static const u64 GLV_A1 = 0x89d3256894d213e3ULL;
static const u64 GLV_B1N[2] = {0x8211bbeb7d4f1128ULL, 0x6f4d8248eeb859fcULL};
static const u64 GLV_A2[2] = {0x0be4e1541221250bULL, 0x6f4d8248eeb859fdULL};
static const u64 GLV_B2 = 0x89d3256894d213e3ULL;
// n1 = floor(2^256 * B2 / r), n2 = floor(2^256 * B1N / r).
static const u64 GLV_N1[2] = {0xd91d232ec7e0b3d7ULL, 0x2ULL};
static const u64 GLV_N2[3] = {0x7a7bd9d4391eb18dULL, 0x4ccef014a773d2cfULL,
                              0x2ULL};

struct GlvHalf {
    u64 k[2];   // |half-scalar| < 2^127
    bool neg;
    bool zero;
};

// (k1, k2) with k = k1 + lambda*k2 (mod r); k must be canonical (< r).
static void glv_decompose(const u64 k[4], GlvHalf &h1, GlvHalf &h2) {
    // c1 = (k * n1) >> 256 — fits one limb.
    u64 prod[7] = {0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 2; j++) {
            u128 s = (u128)prod[i + j] + (u128)k[i] * GLV_N1[j] + (u64)carry;
            prod[i + j] = (u64)s;
            carry = s >> 64;
        }
        prod[i + 2] += (u64)carry;
    }
    u64 c1 = prod[4];
    // c2 = (k * n2) >> 256 — fits two limbs.
    memset(prod, 0, sizeof(prod));
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 3; j++) {
            u128 s = (u128)prod[i + j] + (u128)k[i] * GLV_N2[j] + (u64)carry;
            prod[i + j] = (u64)s;
            carry = s >> 64;
        }
        prod[i + 3] += (u64)carry;
    }
    u64 c2[2] = {prod[4], prod[5]};

    // q = c1*A1 + c2*A2  (4 limbs; actual magnitude < 2^255)
    u64 q[4] = {0, 0, 0, 0};
    {
        u128 s = (u128)c1 * GLV_A1;
        q[0] = (u64)s;
        q[1] = (u64)(s >> 64);
        u128 carry = 0;
        u64 t[4] = {0, 0, 0, 0};
        for (int i = 0; i < 2; i++) {
            carry = 0;
            for (int j = 0; j < 2; j++) {
                u128 s2 = (u128)t[i + j] + (u128)c2[i] * GLV_A2[j] + (u64)carry;
                t[i + j] = (u64)s2;
                carry = s2 >> 64;
            }
            t[i + 2] += (u64)carry;
        }
        carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s2 = (u128)q[i] + t[i] + (u64)carry;
            q[i] = (u64)s2;
            carry = s2 >> 64;
        }
    }
    // k1 = k - q (signed; |k1| < 2^127)
    if (geq(k, q)) {
        u64 d[4];
        sub_raw(d, k, q);
        h1.k[0] = d[0];
        h1.k[1] = d[1];
        h1.neg = false;
    } else {
        u64 d[4];
        sub_raw(d, q, k);
        h1.k[0] = d[0];
        h1.k[1] = d[1];
        h1.neg = true;
    }
    h1.zero = (h1.k[0] | h1.k[1]) == 0;

    // k2 = c1*B1N - c2*B2 (signed; |k2| < 2^127)
    u64 t1[3] = {0, 0, 0}, t2[3] = {0, 0, 0};
    {
        u128 carry = 0;
        for (int j = 0; j < 2; j++) {
            u128 s = (u128)t1[j] + (u128)c1 * GLV_B1N[j] + (u64)carry;
            t1[j] = (u64)s;
            carry = s >> 64;
        }
        t1[2] = (u64)carry;
        u128 s0 = (u128)c2[0] * GLV_B2;
        t2[0] = (u64)s0;
        u128 s1 = (u128)c2[1] * GLV_B2 + (u64)(s0 >> 64);
        t2[1] = (u64)s1;
        t2[2] = (u64)(s1 >> 64);
    }
    bool t1_ge = true;
    for (int i = 2; i >= 0; i--) {
        if (t1[i] != t2[i]) {
            t1_ge = t1[i] > t2[i];
            break;
        }
    }
    u64 d[3];
    {
        const u64 *a = t1_ge ? t1 : t2;
        const u64 *b = t1_ge ? t2 : t1;
        u128 borrow = 0;
        for (int i = 0; i < 3; i++) {
            u128 s = (u128)a[i] - b[i] - (u64)borrow;
            d[i] = (u64)s;
            borrow = (s >> 64) ? 1 : 0;
        }
    }
    h2.k[0] = d[0];
    h2.k[1] = d[1];
    h2.neg = !t1_ge;
    h2.zero = (h2.k[0] | h2.k[1]) == 0;
}

static const u64 *glv_beta_mont() {
    // Callers invoke this before entering the OpenMP region, so the lazy
    // init below is single-threaded.
    static u64 beta_mont[4];
    static bool ready = false;
    if (!ready) {
        to_mont(beta_mont, GLV_BETA_STD, FQ);
        ready = true;
    }
    return beta_mont;
}

// GLV + signed-digit Pippenger.  scs = 4 limbs per scalar, canonical.
static G1J pippenger_affine_glv(const std::vector<AffinePt> &pts,
                                const std::vector<u64> &scs, size_t m) {
    const u64 *beta = glv_beta_mont();
    // Decompose and build the doubled entry list.
    struct Entry {
        AffinePt p;
        u64 k[2];
    };
    std::vector<Entry> entries;
    entries.reserve(2 * m);
    for (size_t i = 0; i < m; i++) {
        GlvHalf h1, h2;
        glv_decompose(&scs[4 * i], h1, h2);
        if (!h1.zero) {
            Entry e;
            e.p = pts[i];
            if (h1.neg) neg_mod(e.p.y, e.p.y, FQ);
            e.k[0] = h1.k[0];
            e.k[1] = h1.k[1];
            entries.push_back(e);
        }
        if (!h2.zero) {
            Entry e;
            e.p.inf = pts[i].inf;
            mmul(e.p.x, pts[i].x, beta, FQ);  // phi: x *= beta
            memcpy(e.p.y, pts[i].y, 32);
            if (h2.neg) neg_mod(e.p.y, e.p.y, FQ);
            e.k[0] = h2.k[0];
            e.k[1] = h2.k[1];
            entries.push_back(e);
        }
    }
    size_t n = entries.size();
    if (n == 0) return g1_zero();

    // Pick c minimizing ceil(129/c) * (n + 2^(c-1)) exactly.  Cap at 16:
    // 2^15 affine buckets = 2.3 MB stays cache-resident; c = 17 measured
    // ~1.5x slower from bucket-array misses despite fewer window passes.
    int c = 2;
    double best = 1e300;
    for (int cand = 2; cand <= 16; cand++) {
        double cost = (double)((129 + cand - 1) / cand) *
                      ((double)n + (double)(1ULL << (cand - 1)));
        if (cost < best) {
            best = cost;
            c = cand;
        }
    }
    if (const char *e = getenv("TNSH_MSM_C")) {
        int v = atoi(e);
        if (v >= 2 && v <= 18) c = v;
    }
    int windows = (129 + c - 1) / c;  // |k| < 2^127 + recode carry headroom
    u64 mask = (1ULL << c) - 1;
    u64 half = 1ULL << (c - 1);
    std::vector<G1J> window_sums(windows);
    // Per-entry signed digits, recoded once (shared across the parallel
    // window loop; digit w of entry i at digits[i*windows + w]).
    std::vector<int32_t> digits((size_t)n * windows);
    for (size_t i = 0; i < n; i++) {
        u64 carry = 0;
        const u64 *k = entries[i].k;
        for (int w = 0; w < windows; w++) {
            int shift = w * c;
            int limb = shift / 64;
            int off = shift % 64;
            u64 d = (limb < 2) ? (k[limb] >> off) : 0;
            if (off + c > 64 && limb + 1 < 2) d |= k[limb + 1] << (64 - off);
            d = (d & mask) + carry;
            if (d > half) {
                digits[i * windows + w] = (int32_t)d - (int32_t)(1ULL << c);
                carry = 1;
            } else {
                digits[i * windows + w] = (int32_t)d;
                carry = 0;
            }
        }
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) if (n >= 16384)
#endif
    for (int w = 0; w < windows; w++) {
        // Chunked sorted-schedule batch-affine bucket accumulation.
        //
        // Items are processed in cache-sized CHUNKS.  Each chunk is
        // counting-sorted by bucket and its per-bucket runs pairwise
        // tree-reduced (all pair-adds in a wave are independent), then the
        // per-bucket survivors merge into the global bucket array — at
        // most one add per bucket per chunk, so the merge is conflict-free
        // too.  Every point addition in the window is therefore a batched
        // AFFINE add (~6 muls amortized vs ~14 for mixed Jacobian), the
        // chunk scratch (~600 KB) and bucket array (<= 2.3 MB) both stay
        // cache-resident, and skewed digit distributions (small scalars
        // concentrating in a few buckets) reduce inside chunks in linear
        // time instead of serializing on hot buckets.
        std::vector<AffinePt> buckets(half + 1);
        for (auto &b : buckets) b.inf = true;
        // 4096 x 72 B scratch = 288 KB: L2-resident; measured best across
        // uniform-full and small-scalar workloads (TNSH_MSM_CHUNK overrides
        // for tuning).
        size_t CHUNK = 4096;
        if (const char *e = getenv("TNSH_MSM_CHUNK")) {
            int v = atoi(e);
            if (v >= 256 && v <= (1 << 20)) CHUNK = (size_t)v;
        }
        std::vector<AffinePt> sc(CHUNK);
        std::vector<uint32_t> bucket_of(CHUNK), order(CHUNK);
        std::vector<uint32_t> cnt(half + 2, 0);
        std::vector<uint32_t> touched;
        touched.reserve(CHUNK);

        const size_t BATCH = 256;
        struct Pair {
            AffinePt *a;        // left operand / result slot
            const AffinePt *b;  // right operand
            uint8_t kind;       // 0 add, 1 double, 2 -> infinity, 3 copy b
        };
        Pair batch[256];
        u64 denom[256][4], pre[256][4], dinv[256][4];
        size_t bn = 0;
        auto flush = [&]() {
            if (bn == 0) return;
            // 4 interleaved inversion chains: the prefix-product
            // recurrence is a strict dependency chain, so one chain is
            // mmul-latency-bound; four keep the multiplier pipeline full.
            u64 chain[4][4];
            for (int l = 0; l < 4; l++) memcpy(chain[l], FQ.one, 32);
            for (size_t j = 0; j < bn; j++) {
                int l = j & 3;
                memcpy(pre[j], chain[l], 32);
                mmul(chain[l], chain[l], denom[j], FQ);
            }
            u64 t01[4], t23[4], T[4], invT[4], i01[4], i23[4], cinv[4][4];
            mmul(t01, chain[0], chain[1], FQ);
            mmul(t23, chain[2], chain[3], FQ);
            mmul(T, t01, t23, FQ);
            minv(invT, T, FQ);
            mmul(i01, invT, t23, FQ);
            mmul(i23, invT, t01, FQ);
            mmul(cinv[0], i01, chain[1], FQ);
            mmul(cinv[1], i01, chain[0], FQ);
            mmul(cinv[2], i23, chain[3], FQ);
            mmul(cinv[3], i23, chain[2], FQ);
            for (size_t j = bn; j-- > 0;) {
                int l = j & 3;
                mmul(dinv[j], cinv[l], pre[j], FQ);
                mmul(cinv[l], cinv[l], denom[j], FQ);
            }
            for (size_t j = 0; j < bn; j++) {
                AffinePt &A = *batch[j].a;
                const AffinePt &B2 = *batch[j].b;
                if (batch[j].kind == 2) {
                    A.inf = true;
                    continue;
                }
                if (batch[j].kind == 3) {
                    A = B2;
                    continue;
                }
                u64 lam[4];
                if (batch[j].kind == 1) {
                    u64 x2[4], t[4];
                    msq(x2, A.x, FQ);
                    add_mod(t, x2, x2, FQ);
                    add_mod(t, t, x2, FQ);
                    mmul(lam, t, dinv[j], FQ);
                } else {
                    u64 t[4];
                    sub_mod(t, B2.y, A.y, FQ);
                    mmul(lam, t, dinv[j], FQ);
                }
                u64 x3[4], y3[4], t[4];
                msq(x3, lam, FQ);
                sub_mod(x3, x3, A.x, FQ);
                sub_mod(x3, x3, batch[j].kind == 1 ? A.x : B2.x, FQ);
                sub_mod(t, A.x, x3, FQ);
                mmul(y3, lam, t, FQ);
                sub_mod(y3, y3, A.y, FQ);
                memcpy(A.x, x3, 32);
                memcpy(A.y, y3, 32);
            }
            bn = 0;
        };
        // Classify a pair (A += B2) and queue it for the batched flush.
        auto queue_add = [&](AffinePt *A, const AffinePt *B2) {
            uint8_t kind;
            u64 *dn = denom[bn];
            if (A->inf) {
                kind = 3;
                memcpy(dn, FQ.one, 32);
            } else if (B2->inf) {
                return;
            } else if (memcmp(A->x, B2->x, 32) == 0) {
                if (memcmp(A->y, B2->y, 32) == 0) {
                    kind = 1;
                    add_mod(dn, A->y, A->y, FQ);
                    if (is_zero4(dn)) {
                        kind = 2;
                        memcpy(dn, FQ.one, 32);
                    }
                } else {
                    kind = 2;  // B2 = -A
                    memcpy(dn, FQ.one, 32);
                }
            } else {
                kind = 0;
                sub_mod(dn, B2->x, A->x, FQ);
            }
            batch[bn].a = A;
            batch[bn].b = B2;
            batch[bn].kind = kind;
            if (++bn == BATCH) flush();
        };

        for (size_t base = 0; base < n; base += CHUNK) {
            size_t lim = base + CHUNK < n ? base + CHUNK : n;
            // Gather this chunk's nonzero-digit items.
            size_t m_ch = 0;
            for (size_t i = base; i < lim; i++) {
                int32_t d = digits[i * windows + w];
                if (!d) continue;
                uint32_t b = d > 0 ? d : -d;
                AffinePt p = entries[i].p;
                if (d < 0) neg_mod(p.y, p.y, FQ);
                if (!cnt[b]) touched.push_back(b);
                cnt[b]++;
                bucket_of[m_ch] = b;
                sc[m_ch] = p;
                m_ch++;
            }
            if (m_ch == 0) continue;
            if (touched.size() == m_ch) {
                // All buckets distinct: merge directly, skip the sort.
                for (size_t j = 0; j < m_ch; j++) {
                    AffinePt &B = buckets[bucket_of[j]];
                    if (B.inf) B = sc[j];
                    else queue_add(&B, &sc[j]);
                }
                flush();
                for (uint32_t b : touched) cnt[b] = 0;
                touched.clear();
                continue;
            }
            // Counting-sort chunk items by bucket (stable enough — order
            // within a bucket is irrelevant for a sum).
            uint32_t off = 0;
            for (uint32_t b : touched) {
                uint32_t c2 = cnt[b];
                cnt[b] = off;  // reuse cnt as the fill cursor
                off += c2;
            }
            for (size_t j = 0; j < m_ch; j++) order[cnt[bucket_of[j]]++] = j;
            // Tree-reduce each run via the order array: wave k pairs
            // order[s+i] with order[s+i+step] for i stepping 2*step.
            // Runs are delimited by bucket_of changes.
            for (uint32_t step = 1; step < m_ch; step <<= 1) {
                size_t s = 0;
                while (s < m_ch) {
                    uint32_t b = bucket_of[order[s]];
                    size_t e = s + 1;
                    while (e < m_ch && bucket_of[order[e]] == b) e++;
                    for (size_t i = s; i + step < e; i += 2 * step)
                        queue_add(&sc[order[i]], &sc[order[i + step]]);
                    s = e;
                }
                flush();
            }
            // Merge each run's survivor (its first slot) into the bucket.
            {
                size_t s = 0;
                while (s < m_ch) {
                    uint32_t b = bucket_of[order[s]];
                    size_t e = s + 1;
                    while (e < m_ch && bucket_of[order[e]] == b) e++;
                    AffinePt &B = buckets[b];
                    if (B.inf) B = sc[order[s]];
                    else queue_add(&B, &sc[order[s]]);
                    s = e;
                }
                flush();
            }
            for (uint32_t b : touched) cnt[b] = 0;
            touched.clear();
        }
        G1J running = g1_zero(), acc = g1_zero();
        for (size_t b = half; b >= 1; b--) {
            running = g1_add_mixed(running, buckets[b]);
            acc = g1_add(acc, running);
        }
        window_sums[w] = acc;
    }
    G1J result = g1_zero();
    for (int w = windows - 1; w >= 0; w--) {
        if (!g1_is_zero(result))
            for (int i = 0; i < c; i++) result = g1_dbl(result);
        result = g1_add(result, window_sums[w]);
    }
    return result;
}

// Shared Pippenger core over affine points.
static G1J pippenger_affine(const std::vector<AffinePt> &pts,
                            const std::vector<u64> &scs, size_t m) {
    if (m == 0) return g1_zero();
    if (m >= 32) return pippenger_affine_glv(pts, scs, m);
    int c = 1;
    while ((size_t(1) << c) < m && c < 16) c++;
    if (c < 2 && m > 2) c = 2;
    int windows = (254 + c - 1) / c;
    u64 mask = (1ULL << c) - 1;
    std::vector<G1J> window_sums(windows);
    // m < 32 here: serial is always cheaper than an OMP team wake.
    for (int w = 0; w < windows; w++) {
        std::vector<G1J> buckets((size_t(1) << c), g1_zero());
        int shift = w * c;
        for (size_t i = 0; i < m; i++) {
            const u64 *k = &scs[4 * i];
            int limb = shift / 64;
            int off = shift % 64;
            u64 d = k[limb] >> off;
            if (off + c > 64 && limb + 1 < 4) d |= k[limb + 1] << (64 - off);
            d &= mask;
            if (d) buckets[d] = g1_add_mixed(buckets[d], pts[i]);
        }
        G1J running = g1_zero(), acc = g1_zero();
        for (size_t d = buckets.size() - 1; d >= 1; d--) {
            running = g1_add(running, buckets[d]);
            acc = g1_add(acc, running);
        }
        window_sums[w] = acc;
    }
    G1J result = g1_zero();
    for (int w = windows - 1; w >= 0; w--) {
        if (!g1_is_zero(result))
            for (int i = 0; i < c; i++) result = g1_dbl(result);
        result = g1_add(result, window_sums[w]);
    }
    return result;
}

// Parse (point, scalar) byte pairs into the affine Pippenger core.
static G1J pippenger_affine_entry(const uint8_t *points,
                                  const uint8_t *scalars, size_t n) {
    std::vector<AffinePt> pts;
    std::vector<u64> scs;
    pts.reserve(n);
    for (size_t i = 0; i < n; i++) {
        u64 k[4];
        bytes_to_limbs(k, scalars + 32 * i);
        if (is_zero4(k)) continue;
        u64 x[4], y[4];
        bytes_to_limbs(x, points + 64 * i);
        bytes_to_limbs(y, points + 64 * i + 32);
        if (is_zero4(x) && is_zero4(y)) continue;
        AffinePt p;
        p.inf = false;
        to_mont(p.x, x, FQ);
        to_mont(p.y, y, FQ);
        pts.push_back(p);
        scs.insert(scs.end(), k, k + 4);
    }
    return pippenger_affine(pts, scs, pts.size());
}

extern "C" {

// Build an SRS of n points s_i * base in native memory; returns handle id.
int srs_create_fixed_base(const uint8_t *base, const uint8_t *scalars,
                          size_t n) {
    G1J b = g1_from_bytes(base);
    std::vector<G1J> jac(n);
    const int W = 32, D = 256;
    std::vector<G1J> table(W * D);
    G1J wb = b;
    for (int w = 0; w < W; w++) {
        table[w * D] = g1_zero();
        table[w * D + 1] = wb;
        for (int d = 2; d < D; d++)
            table[w * D + d] = g1_add(table[w * D + d - 1], wb);
        for (int k = 0; k < 8; k++) wb = g1_dbl(wb);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 1024)
#endif
    for (size_t i = 0; i < n; i++) {
        u64 k[4];
        bytes_to_limbs(k, scalars + 32 * i);
        G1J acc = g1_zero();
        for (int w = 0; w < W; w++) {
            int d = (int)((k[w / 8] >> ((w % 8) * 8)) & 0xFF);
            if (d) acc = g1_add(acc, table[w * D + d]);
        }
        jac[i] = acc;
    }
    g_srs_store.emplace_back();
    g1_batch_to_affine(jac, g_srs_store.back());
    return (int)g_srs_store.size() - 1;
}

// Load an SRS from affine standard-form bytes (64 B per point).
int srs_create_from_points(const uint8_t *points, size_t n) {
    std::vector<G1J> jac(n);
    for (size_t i = 0; i < n; i++) jac[i] = g1_from_bytes(points + 64 * i);
    g_srs_store.emplace_back();
    g1_batch_to_affine(jac, g_srs_store.back());
    return (int)g_srs_store.size() - 1;
}

long srs_size(int id) {
    if (id < 0 || id >= (int)g_srs_store.size()) return -1;
    return (long)g_srs_store[id].size();
}

void srs_get_point(int id, size_t idx, uint8_t *out) {
    const AffinePt &p = g_srs_store[id][idx];
    if (p.inf) {
        memset(out, 0, 64);
        return;
    }
    u64 s[4];
    from_mont(s, p.x, FQ);
    limbs_to_bytes(out, s);
    from_mont(s, p.y, FQ);
    limbs_to_bytes(out + 32, s);
}

// Per-(chunk, window, |digit|) occupancy counts for the device MSM planner.
// d: (w_count, n_pad) row-major int8 signed digits; out: zero-initialized
// (n_pad/m, w_count, 129) int32 counts.  (numpy bincount measured ~4 M/s on
// this host — this loop is memory-bound at GB/s.)
void msm_digit_counts(const int8_t *d, size_t w_count, size_t n_pad,
                      size_t m, int32_t *out) {
    size_t chunks = n_pad / m;
    long total = (long)(chunks * w_count);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n_pad * w_count >= 262144)
#endif
    for (long t = 0; t < total; t++) {
        size_t g = (size_t)t / w_count, w = (size_t)t % w_count;
        const int8_t *row = d + w * n_pad + g * m;
        int32_t *o = out + (size_t)t * 129;
        for (size_t i = 0; i < m; i++) {
            int v = (int)row[i];
            o[v < 0 ? -v : v]++;
        }
    }
}

// Bulk export of SRS points [start, start+count) as standard-form affine
// bytes (64 B per point, identity = all-zero).  One call replaces count
// srs_get_point round-trips; feeds the device MSM's device-resident planes.
void srs_export_affine(int id, size_t start, size_t count, uint8_t *out) {
    if (id < 0 || id >= (int)g_srs_store.size()) return;
    const std::vector<AffinePt> &all = g_srs_store[id];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (count >= 16384)
#endif
    for (long k = 0; k < (long)count; k++) {
        size_t i = start + (size_t)k;
        uint8_t *o = out + 64 * (size_t)k;
        if (i >= all.size() || all[i].inf) {
            memset(o, 0, 64);
            continue;
        }
        u64 s[4];
        from_mont(s, all[i].x, FQ);
        limbs_to_bytes(o, s);
        from_mont(s, all[i].y, FQ);
        limbs_to_bytes(o + 32, s);
    }
}

// MSM of the first n SRS points against n scalars.
void srs_msm(int id, const uint8_t *scalars, size_t n, uint8_t *out) {
    const std::vector<AffinePt> &all = g_srs_store[id];
    std::vector<AffinePt> pts;
    std::vector<u64> scs;
    pts.reserve(n);
    for (size_t i = 0; i < n && i < all.size(); i++) {
        u64 k[4];
        bytes_to_limbs(k, scalars + 32 * i);
        if (is_zero4(k) || all[i].inf) continue;
        pts.push_back(all[i]);
        scs.insert(scs.end(), k, k + 4);
    }
    g1_to_bytes(out, pippenger_affine(pts, scs, pts.size()));
}

void srs_free(int id) {
    if (id >= 0 && id < (int)g_srs_store.size()) {
        g_srs_store[id].clear();
        g_srs_store[id].shrink_to_fit();
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fiat-Shamir challenge kernel
//
// Native twin of tnsh/core/transcript.py::challenge_field_element — the
// reference's Transcript (utils.rs:172-192): digest the accumulated state
// with Rust's DefaultHasher (SipHash-1-3, zero keys, 8-byte LE length
// prefix), tile the 64-bit digest to a 32-byte ChaCha20 seed, and draw one
// ark-ff 0.4.2 Fr::rand sample (4 sequential u64 limbs, top limb masked to
// 254 bits, rejection-sampled below r, interpreted as the Montgomery
// representation).  Bit-exactness is locked by tests/test_golden_vectors.py
// and the Python-vs-native equality test in tests/test_rng.py.
// ---------------------------------------------------------------------------

static inline u64 sip_rotl64(u64 v, int s) { return (v << s) | (v >> (64 - s)); }
static inline uint32_t cc_rotl32(uint32_t v, int s) {
    return (v << s) | (v >> (32 - s));
}

static inline void sip_rounds13(u64 &v0, u64 &v1, u64 &v2, u64 &v3, int n) {
    for (int i = 0; i < n; i++) {
        v0 += v1; v1 = sip_rotl64(v1, 13); v1 ^= v0; v0 = sip_rotl64(v0, 32);
        v2 += v3; v3 = sip_rotl64(v3, 16); v3 ^= v2;
        v0 += v3; v3 = sip_rotl64(v3, 21); v3 ^= v0;
        v2 += v1; v1 = sip_rotl64(v1, 17); v1 ^= v2; v2 = sip_rotl64(v2, 32);
    }
}

// SipHash-1-3(le64(len) || data), keys zero — Rust DefaultHasher over Vec<u8>.
static u64 siphash13_vec(const uint8_t *data, size_t len) {
    u64 v0 = 0x736F6D6570736575ULL, v1 = 0x646F72616E646F6DULL;
    u64 v2 = 0x6C7967656E657261ULL, v3 = 0x7465646279746573ULL;
    size_t total = len + 8;
    u64 m = (u64)len;  // aligned 8-byte length-prefix word
    v3 ^= m; sip_rounds13(v0, v1, v2, v3, 1); v0 ^= m;
    size_t n_full = len / 8;
    for (size_t i = 0; i < n_full; i++) {
        memcpy(&m, data + 8 * i, 8);
        v3 ^= m; sip_rounds13(v0, v1, v2, v3, 1); v0 ^= m;
    }
    u64 b = (u64)(total & 0xFF) << 56, t = 0;
    memcpy(&t, data + 8 * n_full, len - 8 * n_full);
    b |= t;
    v3 ^= b; sip_rounds13(v0, v1, v2, v3, 1); v0 ^= b;
    v2 ^= 0xFF; sip_rounds13(v0, v1, v2, v3, 3);
    return v0 ^ v1 ^ v2 ^ v3;
}

// One 64-byte djb-variant ChaCha20 block (64-bit counter, zero nonce).
static void chacha20_block(const uint32_t key[8], u64 counter,
                           uint8_t out[64]) {
    uint32_t st[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                       key[0], key[1], key[2], key[3],
                       key[4], key[5], key[6], key[7],
                       (uint32_t)counter, (uint32_t)(counter >> 32), 0, 0};
    uint32_t x[16];
    memcpy(x, st, 64);
#define TNSH_QR(a, b, c, d)                                   \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = cc_rotl32(x[d], 16);   \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = cc_rotl32(x[b], 12);   \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = cc_rotl32(x[d], 8);    \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = cc_rotl32(x[b], 7);
    for (int i = 0; i < 10; i++) {
        TNSH_QR(0, 4, 8, 12) TNSH_QR(1, 5, 9, 13)
        TNSH_QR(2, 6, 10, 14) TNSH_QR(3, 7, 11, 15)
        TNSH_QR(0, 5, 10, 15) TNSH_QR(1, 6, 11, 12)
        TNSH_QR(2, 7, 8, 13) TNSH_QR(3, 4, 9, 14)
    }
#undef TNSH_QR
    for (int i = 0; i < 16; i++) {
        uint32_t w = x[i] + st[i];
        memcpy(out + 4 * i, &w, 4);
    }
}

extern "C" {

// out: 32-byte LE standard-form Fr challenge for the given transcript state.
void fs_challenge(const uint8_t *state, size_t len, uint8_t *out) {
    u64 digest = siphash13_vec(state, len);
    uint32_t key[8];
    for (int i = 0; i < 4; i++) {
        key[2 * i] = (uint32_t)digest;
        key[2 * i + 1] = (uint32_t)(digest >> 32);
    }
    uint8_t buf[64];
    u64 counter = 0;
    size_t pos = 64;  // draws are 8-byte aligned, so pos never straddles
    u64 limbs[4];
    for (;;) {
        for (int i = 0; i < 4; i++) {
            if (pos == 64) {
                chacha20_block(key, counter++, buf);
                pos = 0;
            }
            memcpy(&limbs[i], buf + pos, 8);
            pos += 8;
        }
        limbs[3] &= ~0ULL >> 2;
        if (!geq(limbs, FR.p)) break;
    }
    u64 std_form[4];
    from_mont(std_form, limbs, FR);  // Montgomery repr -> u * R^{-1} mod r
    limbs_to_bytes(out, std_form);
}

}  // extern "C"

// ---- bit-column sound protocols: native k-phase oracles ----
//
// Backs tnsh.iop.bits_oracle's structured O(T logK) oracles (TwistBits /
// ShoutBits, tnsh/protocols/twist_bits.py).  The k rounds walk the T cycle
// columns once per round with suffix-bucket lookups (Twist's virtual Val)
// or folded k-table lookups (Shout's public table); after the last k bind
// the j-phase delegate is built natively as a generic-degree sop handle —
// no T-sized table ever round-trips through Python.  Bit-identical to the
// pure-Python oracles (exact field arithmetic, order-independent sums).

struct TbkState {
    int log_k, log_t, npts, round;
    size_t t_size;
    std::vector<u64> r_addr, w_addr;    // remaining address suffixes
    std::vector<u64> Ar, Aw;            // 4*t, running chi products (Mont)
    std::vector<u64> rv, wv, ic;        // 4*t each, Montgomery
    std::vector<u64> eq1, eqsj, eqb;    // 4*t each, Montgomery
    std::vector<uint8_t> ot_b;          // write flags (0/1)
    std::vector<u64> eqsk;              // folded eq(sigma_k) table (Mont)
    std::vector<u64> apow;              // alpha powers (Mont), >= 2+2logk+1
    u64 kinv[4];                        // 1/K (Mont)
    // -kinv * sum_j eq1[j] rv[j] (Mont), cached across the k rounds —
    // the j tables never fold during the k phase, so the lift sum is
    // invariant (only the 2^free scaling changes per round)
    u64 rv_lift[4];
    bool rv_lift_ok = false;
};

static std::vector<TbkState *> g_tbk_store;

static void tbk_frvec(std::vector<u64> &dst, const uint8_t *src, size_t n) {
    dst.resize(4 * n);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 65536)
#endif
    for (long long i = 0; i < (long long)n; i++) {
        u64 raw[4];
        bytes_to_limbs(raw, src + 32 * i);
        to_mont(&dst[4 * i], raw, FR);
    }
}

// Montgomery small-int helpers: mont(x) and mont((1 - x) mod p) for the
// X-point grid 0..npts-1, and mont(2^e).
static void tbk_xgrid(int npts, std::vector<u64> &xm, std::vector<u64> &cxm) {
    xm.assign(4 * npts, 0);
    cxm.assign(4 * npts, 0);
    u64 cur[4] = {0, 0, 0, 0};
    for (int x = 0; x < npts; x++) {
        memcpy(&xm[4 * x], cur, 32);
        u64 c[4];
        sub_mod(c, FR.one, cur, FR);  // 1 - x
        memcpy(&cxm[4 * x], c, 32);
        add_mod(cur, cur, FR.one, FR);
    }
}

static void tbk_pow2(u64 out[4], int e) {
    memcpy(out, FR.one, 32);
    for (int i = 0; i < e; i++) add_mod(out, out, out, FR);
}

extern "C" {

// addr arrays: t_size u64 each; ot_flags: t_size bytes; field columns
// (rv, wv, ic, eq1, eqsj, eqb): t_size * 32 B standard form; eqsk:
// 2^log_k * 32 B; apow: n_apow * 32 B; kinv: 32 B.
int tbk_create(int log_k, int log_t, const uint64_t *r_addr,
               const uint64_t *w_addr, const uint8_t *ot_flags,
               const uint8_t *rv_col,
               const uint8_t *wv_col, const uint8_t *ic_col,
               const uint8_t *eq1_col, const uint8_t *eqsj_col,
               const uint8_t *eqb_col, const uint8_t *eqsk_tab,
               const uint8_t *apow, size_t n_apow, const uint8_t *kinv,
               int npts) {
    TbkState *st = new TbkState();
    st->log_k = log_k;
    st->log_t = log_t;
    st->npts = npts;
    st->round = 0;
    st->t_size = (size_t)1 << log_t;
    size_t t = st->t_size;
    st->r_addr.assign(r_addr, r_addr + t);
    st->w_addr.assign(w_addr, w_addr + t);
    st->ot_b.assign(ot_flags, ot_flags + t);
    st->Ar.resize(4 * t);
    st->Aw.resize(4 * t);
    for (size_t j = 0; j < t; j++) {
        memcpy(&st->Ar[4 * j], FR.one, 32);
        memcpy(&st->Aw[4 * j], FR.one, 32);
    }
    tbk_frvec(st->rv, rv_col, t);
    tbk_frvec(st->wv, wv_col, t);
    tbk_frvec(st->ic, ic_col, t);
    tbk_frvec(st->eq1, eq1_col, t);
    tbk_frvec(st->eqsj, eqsj_col, t);
    tbk_frvec(st->eqb, eqb_col, t);
    tbk_frvec(st->eqsk, eqsk_tab, (size_t)1 << log_k);
    tbk_frvec(st->apow, apow, n_apow);
    u64 raw[4];
    bytes_to_limbs(raw, kinv);
    to_mont(st->kinv, raw, FR);
    return store_put(g_tbk_store, st);
}

// out: npts * 32 B — phase-A round evaluations for k round st->round.
// Mirrors TwistBitsSparseOracle._k_round_evals: the boolean-check lift
// terms are identically zero for boolean columns (b^2 - b = 0) and the
// Python loop adds exactly 0 for them, so only the rv lift term remains.
void tbk_round_evals(int id, uint8_t *out) {
    TbkState *st = g_tbk_store[id];
    const int npts = st->npts;
    const int i = st->round;
    const size_t t = st->t_size;
    std::vector<u64> xm, cxm;
    tbk_xgrid(npts, xm, cxm);
    u64 pow_free[4];
    tbk_pow2(pow_free, st->log_k - i - 1);
    const u64 *a1 = &st->apow[4];

    // rv lift term: -kinv * sum_j eq1[j] * rv[j], times 2^free
    if (!st->rv_lift_ok) {
        u64 lift0[4] = {0, 0, 0, 0};
#ifdef _OPENMP
#pragma omp parallel if (t >= 16384)
#endif
        {
            u64 local[4] = {0, 0, 0, 0};
#ifdef _OPENMP
#pragma omp for schedule(static) nowait
#endif
            for (long long j = 0; j < (long long)t; j++) {
                u64 v[4];
                mmul(v, &st->eq1[4 * j], &st->rv[4 * j], FR);
                add_mod(local, local, v, FR);
            }
#ifdef _OPENMP
#pragma omp critical
#endif
            add_mod(lift0, lift0, local, FR);
        }
        mmul(lift0, lift0, st->kinv, FR);
        neg_mod(lift0, lift0, FR);
        memcpy(st->rv_lift, lift0, 32);
        st->rv_lift_ok = true;
    }
    u64 lift[4];
    mmul(lift, st->rv_lift, pow_free, FR);

    std::vector<u64> acc(4 * npts);
    for (int x = 0; x < npts; x++) memcpy(&acc[4 * x], lift, 32);

    // one ascending-j walk: suffix buckets B[addr] = sum ic*Aw over
    // earlier writes with that remaining address.  The bucket state is a
    // prefix scan, so chunks are parallelized by a cheap insert-only
    // pre-pass that snapshots B at chunk starts (exact field sums,
    // order-independent — identical to the sequential walk).
    size_t nb = (size_t)1 << (st->log_k - i);
    const u64 *E = st->eqsk.data();
    int nchunks = 1;
#ifdef _OPENMP
    if (t >= 8192) nchunks = omp_get_max_threads();
#endif
    if (nchunks > (int)(t / 4096)) nchunks = (int)(t / 4096);
    if (nchunks < 1) nchunks = 1;
    std::vector<std::vector<u64>> snap(nchunks);
    if (nchunks > 1) {
        std::vector<u64> Bpre(4 * nb, 0);
        size_t per = (t + nchunks - 1) / nchunks;
        int c = 0;
        for (size_t j = 0; j < t; j++) {
            if (j == per * (size_t)c && c < nchunks) snap[c++] = Bpre;
            if (st->ot_b[j]) {
                u64 add[4];
                mmul(add, &st->ic[4 * j], &st->Aw[4 * j], FR);
                add_mod(&Bpre[4 * st->w_addr[j]],
                        &Bpre[4 * st->w_addr[j]], add, FR);
            }
        }
        while (c < nchunks) snap[c++] = Bpre;
    } else {
        snap[0].assign(4 * nb, 0);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(nchunks) \
    if (nchunks > 1)
#endif
    for (int chunk = 0; chunk < nchunks; chunk++) {
    size_t per = (t + nchunks - 1) / nchunks;
    size_t j_lo = per * (size_t)chunk;
    size_t j_hi = j_lo + per < t ? j_lo + per : t;
    std::vector<u64> B = std::move(snap[chunk]);
    // accumulate-then-extend: the READ contribution is quadratic and the
    // INC contribution cubic in X, so per cycle only their sub-grid
    // values (X=0..2 / 0..3) are banked; ONE forward-difference
    // extension per chunk replaces the per-cycle extension (FD is
    // linear over exact field sums — identical values).
    const int rdd = npts - 1 < 2 ? npts - 1 : 2;
    const int idd = npts - 1 < 3 ? npts - 1 : 3;
    u64 racc[3][4], iacc[4][4];
    memset(racc, 0, sizeof(racc));
    memset(iacc, 0, sizeof(iacc));
    std::vector<u64> lacc(4 * npts, 0);
    for (size_t j = j_lo; j < j_hi; j++) {
        // READ: eq1 * (1 - ot) * Ar * chi(X, b) * V-part(X).  ot is a
        // bit column, so rt = 1 - ot is EXACTLY mont(1) on reads (the
        // multiply is an identity and is elided) and 0 on writes (the
        // whole READ contribution vanishes).
        if (!st->ot_b[j]) {
            u64 w[4];
            mmul(w, &st->eq1[4 * j], &st->Ar[4 * j], FR);
            if (!is_zero4(w)) {
            u64 ra = st->r_addr[j];
            int b = (int)(ra & 1);
            const u64 *b0 = &B[4 * ((ra >> 1) << 1)];
            const u64 *b1 = &B[4 * (((ra >> 1) << 1) + 1)];
            u64 d[4];
            sub_mod(d, b1, b0, FR);
            for (int x = 0; x <= rdd; x++) {
                u64 vp[4], m[4];
                mmul(vp, &xm[4 * x], d, FR);
                add_mod(vp, vp, b0, FR);
                mmul(m, w, b ? &xm[4 * x] : &cxm[4 * x], FR);
                mmul(m, m, vp, FR);
                add_mod(racc[x], racc[x], m, FR);
            }
            }
        } else {
            // write cycle: ot is exactly mont(1), so base = eqsj * Aw
            u64 wa = st->w_addr[j];
            int b = (int)(wa & 1);
            u64 base[4];
            mmul(base, &st->eqsj[4 * j], &st->Aw[4 * j], FR);
            if (!is_zero4(base)) {
                u64 s = wa >> 1;
                const u64 *et0 = &E[8 * s];
                u64 edt[4];
                sub_mod(edt, &E[8 * s + 4], et0, FR);
                const u64 *b0 = &B[4 * ((wa >> 1) << 1)];
                const u64 *b1 = &B[4 * (((wa >> 1) << 1) + 1)];
                u64 bd[4], ic_wv[4], head0[4];
                sub_mod(bd, b1, b0, FR);
                sub_mod(ic_wv, &st->ic[4 * j], &st->wv[4 * j], FR);
                mmul(head0, a1, base, FR);
                // g(X) = head0 * chi(X,b) * ek(X) * (ic_wv + vp(X))
                for (int x = 0; x <= idd; x++) {
                    u64 ek[4], head[4], m[4], vp[4];
                    mmul(ek, &xm[4 * x], edt, FR);
                    add_mod(ek, ek, et0, FR);
                    const u64 *cx = b ? &xm[4 * x] : &cxm[4 * x];
                    mmul(head, head0, cx, FR);
                    mmul(head, head, ek, FR);
                    mmul(vp, &xm[4 * x], bd, FR);
                    add_mod(vp, vp, b0, FR);
                    add_mod(vp, vp, ic_wv, FR);
                    mmul(m, head, vp, FR);
                    add_mod(iacc[x], iacc[x], m, FR);
                }
            }
            // bucket insert AFTER this cycle's own contributions
            u64 add[4];
            mmul(add, &st->ic[4 * j], &st->Aw[4 * j], FR);
            add_mod(&B[4 * wa], &B[4 * wa], add, FR);
        }
    }
    // extend the banked quadratic / cubic sums across the full X grid
    for (int x = 0; x <= rdd; x++)
        add_mod(&lacc[4 * x], &lacc[4 * x], racc[x], FR);
    if (rdd + 1 < npts) {
        u64 diffs[4][4];
        fd_init(diffs, racc, rdd);
        for (int x = rdd + 1; x < npts; x++) {
            fd_step(diffs, rdd);
            add_mod(&lacc[4 * x], &lacc[4 * x], diffs[0], FR);
        }
    }
    for (int x = 0; x <= idd; x++)
        add_mod(&lacc[4 * x], &lacc[4 * x], iacc[x], FR);
    if (idd + 1 < npts) {
        u64 diffs[4][4];
        fd_init(diffs, iacc, idd);
        for (int x = idd + 1; x < npts; x++) {
            fd_step(diffs, idd);
            add_mod(&lacc[4 * x], &lacc[4 * x], diffs[0], FR);
        }
    }
#ifdef _OPENMP
#pragma omp critical
#endif
    for (int x = 0; x < npts; x++)
        add_mod(&acc[4 * x], &acc[4 * x], &lacc[4 * x], FR);
    }
    for (int x = 0; x < npts; x++) {
        u64 s[4];
        from_mont(s, &acc[4 * x], FR);
        limbs_to_bytes(out + 32 * x, s);
    }
}

void tbk_bind(int id, const uint8_t *r_bytes) {
    TbkState *st = g_tbk_store[id];
    u64 raw[4], r[4], om[4];
    bytes_to_limbs(raw, r_bytes);
    to_mont(r, raw, FR);
    sub_mod(om, FR.one, r, FR);
    const size_t t = st->t_size;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (t >= 16384)
#endif
    for (long long j = 0; j < (long long)t; j++) {
        u64 ra = st->r_addr[j], wa = st->w_addr[j];
        mmul(&st->Ar[4 * j], &st->Ar[4 * j], (ra & 1) ? r : om, FR);
        mmul(&st->Aw[4 * j], &st->Aw[4 * j], (wa & 1) ? r : om, FR);
        st->r_addr[j] = ra >> 1;
        st->w_addr[j] = wa >> 1;
    }
    size_t half = st->eqsk.size() / 8;
    std::vector<u64> nxt(4 * half);
    for (size_t m = 0; m < half; m++) {
        u64 d[4];
        sub_mod(d, &st->eqsk[8 * m + 4], &st->eqsk[8 * m], FR);
        mmul(d, r, d, FR);
        add_mod(&nxt[4 * m], &st->eqsk[8 * m], d, FR);
    }
    st->eqsk.swap(nxt);
    st->round++;
}

void tbk_free(int id) {
    if (id >= 0 && id < (int)g_tbk_store.size() && g_tbk_store[id]) {
        delete g_tbk_store[id];
        g_tbk_store[id] = nullptr;
    }
}

}  // extern "C"

// ---- ShoutBits structured k-phase ----

struct SbkTerm {
    u64 coeff[4];             // Montgomery
    std::vector<int> jt;      // j-table factor indices
    int addr_idx;             // -1: j-lifted constant term
    int kt_idx;               // -1: no k table
    // k-phase shortcuts (computed once at create):
    bool zero_lift = false;   // booleanity pair summing to 0 identically
    bool lift_cached = false; // lifted sum below is valid
    u64 lift_sum[4];          // sum_j coeff * prod jt[j] (Mont) — the j
                              // tables never fold during the k phase, so
                              // lifted sums are round-invariant
};

struct SbkState {
    int log_k, log_t, npts, round;
    size_t t_size;
    std::vector<std::vector<u64>> jt;       // 4*t each, Montgomery
    std::vector<std::vector<u64>> addr;     // per addr table: suffixes
    std::vector<std::vector<u64>> A;        // per addr table: 4*t Mont
    std::vector<std::vector<u64>> kt;       // folding k tables, Mont
    std::vector<SbkTerm> terms;
};

static std::vector<SbkState *> g_sbk_store;

extern "C" {

// jt_blob: n_jt * t_size * 32 B; addrs: n_addr * t_size u64; kt_blob:
// n_kt * 2^log_k * 32 B; coeffs: n_terms * 32 B; spec per term:
// [n_f, jt_idx..., addr_idx, kt_idx].
int sbk_create(int log_k, int log_t, const uint8_t *jt_blob, size_t n_jt,
               const uint64_t *addrs, size_t n_addr, const uint8_t *kt_blob,
               size_t n_kt, const uint8_t *coeffs, const int32_t *spec,
               size_t n_terms, int npts) {
    SbkState *st = new SbkState();
    st->log_k = log_k;
    st->log_t = log_t;
    st->npts = npts;
    st->round = 0;
    st->t_size = (size_t)1 << log_t;
    size_t t = st->t_size;
    size_t k = (size_t)1 << log_k;
    st->jt.resize(n_jt);
    for (size_t i = 0; i < n_jt; i++)
        tbk_frvec(st->jt[i], jt_blob + 32 * t * i, t);
    st->addr.resize(n_addr);
    st->A.resize(n_addr);
    for (size_t i = 0; i < n_addr; i++) {
        st->addr[i].assign(addrs + t * i, addrs + t * (i + 1));
        st->A[i].resize(4 * t);
        for (size_t j = 0; j < t; j++)
            memcpy(&st->A[i][4 * j], FR.one, 32);
    }
    st->kt.resize(n_kt);
    for (size_t i = 0; i < n_kt; i++)
        tbk_frvec(st->kt[i], kt_blob + 32 * k * i, k);
    size_t off = 0;
    for (size_t i = 0; i < n_terms; i++) {
        SbkTerm tm;
        u64 raw[4];
        bytes_to_limbs(raw, coeffs + 32 * i);
        to_mont(tm.coeff, raw, FR);
        int nf = spec[off++];
        for (int f = 0; f < nf; f++) tm.jt.push_back(spec[off++]);
        tm.addr_idx = spec[off++];
        tm.kt_idx = spec[off++];
        st->terms.push_back(tm);
    }
    // Booleanity-check pairs {e,c,c} + -w {e,c} with a VERIFIED boolean
    // column c sum to w * e_j * (c_j^2 - c_j) = 0 for every j, every k
    // round (j tables never fold during the k phase) — skip both terms.
    {
        std::vector<signed char> memo(st->jt.size(), -1);
        auto boolq = [&](int idx) {
            if (memo[idx] < 0)
                memo[idx] = sop_tab_is_bool(st->jt[idx], t) ? 1 : 0;
            return memo[idx] == 1;
        };
        for (size_t i = 0; i < st->terms.size(); i++) {
            SbkTerm &t1 = st->terms[i];
            if (t1.zero_lift || t1.addr_idx >= 0 || t1.kt_idx >= 0)
                continue;
            if (t1.jt.size() != 3 || t1.jt[1] != t1.jt[2]
                    || t1.jt[0] == t1.jt[1] || !boolq(t1.jt[1]))
                continue;
            for (size_t j2 = 0; j2 < st->terms.size(); j2++) {
                SbkTerm &t2 = st->terms[j2];
                if (t2.zero_lift || t2.addr_idx >= 0 || t2.kt_idx >= 0)
                    continue;
                if (t2.jt.size() != 2 || t2.jt[0] != t1.jt[0]
                        || t2.jt[1] != t1.jt[1])
                    continue;
                u64 negc[4];
                neg_mod(negc, t1.coeff, FR);
                if (memcmp(negc, t2.coeff, 32) != 0) continue;
                t1.zero_lift = t2.zero_lift = true;
                break;
            }
        }
    }
    return store_put(g_sbk_store, st);
}

// out: npts * 32 B.  Mirrors ShoutBitsSparseOracle._k_round_evals.
void sbk_round_evals(int id, uint8_t *out) {
    SbkState *st = g_sbk_store[id];
    const int npts = st->npts;
    const size_t t = st->t_size;
    std::vector<u64> xm, cxm;
    tbk_xgrid(npts, xm, cxm);
    u64 pow_free[4];
    tbk_pow2(pow_free, st->log_k - st->round - 1);
    std::vector<u64> acc(4 * npts, 0);
    for (SbkTerm &tm : st->terms) {
        if (tm.addr_idx < 0) {
            if (tm.zero_lift) continue;  // identically 0 (see sbk_create)
            if (!tm.lift_cached) {
                u64 s0[4] = {0, 0, 0, 0};
#ifdef _OPENMP
#pragma omp parallel if (t >= 16384)
#endif
                {
                    u64 local[4] = {0, 0, 0, 0};
#ifdef _OPENMP
#pragma omp for schedule(static) nowait
#endif
                    for (long long j = 0; j < (long long)t; j++) {
                        u64 prod[4];
                        memcpy(prod, tm.coeff, 32);
                        for (int f : tm.jt)
                            mmul(prod, prod, &st->jt[f][4 * j], FR);
                        add_mod(local, local, prod, FR);
                    }
#ifdef _OPENMP
#pragma omp critical
#endif
                    add_mod(s0, s0, local, FR);
                }
                memcpy(tm.lift_sum, s0, 32);
                tm.lift_cached = true;
            }
            u64 s[4];
            mmul(s, tm.lift_sum, pow_free, FR);
            for (int x = 0; x < npts; x++)
                add_mod(&acc[4 * x], &acc[4 * x], s, FR);
            continue;
        }
        const std::vector<u64> &addr = st->addr[tm.addr_idx];
        const std::vector<u64> &A = st->A[tm.addr_idx];
        const u64 *T = tm.kt_idx >= 0 ? st->kt[tm.kt_idx].data() : nullptr;
        std::vector<u64> local_acc(4 * npts, 0);
#ifdef _OPENMP
#pragma omp parallel if (t >= 16384)
#endif
        {
            std::vector<u64> lacc(4 * npts, 0);
#ifdef _OPENMP
#pragma omp for schedule(static) nowait
#endif
            for (long long j = 0; j < (long long)t; j++) {
                u64 w[4];
                mmul(w, tm.coeff, &A[4 * j], FR);
                for (int f : tm.jt) mmul(w, w, &st->jt[f][4 * j], FR);
                if (is_zero4(w)) continue;
                u64 a = addr[j];
                int b = (int)(a & 1);
                u64 s_j = a >> 1;
                u64 t0[4], dt[4];
                if (T) {
                    memcpy(t0, &T[8 * s_j], 32);
                    sub_mod(dt, &T[8 * s_j + 4], t0, FR);
                } else {
                    memcpy(t0, FR.one, 32);
                    memset(dt, 0, 32);
                }
                // g(X) = w * chi(X,b) * (t0 + X dt): quadratic —
                // direct at X=0..2, forward differences after
                int dd = npts - 1 < 2 ? npts - 1 : 2;
                u64 fv[4][4];
                for (int x = 0; x <= dd; x++) {
                    const u64 *cx = b ? &xm[4 * x] : &cxm[4 * x];
                    u64 tv[4], m[4];
                    mmul(tv, &xm[4 * x], dt, FR);
                    add_mod(tv, tv, t0, FR);
                    mmul(m, w, cx, FR);
                    mmul(m, m, tv, FR);
                    memcpy(fv[x], m, 32);
                    add_mod(&lacc[4 * x], &lacc[4 * x], m, FR);
                }
                if (dd + 1 < npts) {
                    u64 diffs[4][4];
                    fd_init(diffs, fv, dd);
                    for (int x = dd + 1; x < npts; x++) {
                        fd_step(diffs, dd);
                        add_mod(&lacc[4 * x], &lacc[4 * x], diffs[0],
                                FR);
                    }
                }
            }
#ifdef _OPENMP
#pragma omp critical
#endif
            for (int x = 0; x < npts; x++)
                add_mod(&local_acc[4 * x], &local_acc[4 * x],
                        &lacc[4 * x], FR);
        }
        for (int x = 0; x < npts; x++)
            add_mod(&acc[4 * x], &acc[4 * x], &local_acc[4 * x], FR);
    }
    for (int x = 0; x < npts; x++) {
        u64 s[4];
        from_mont(s, &acc[4 * x], FR);
        limbs_to_bytes(out + 32 * x, s);
    }
}

void sbk_bind(int id, const uint8_t *r_bytes) {
    SbkState *st = g_sbk_store[id];
    u64 raw[4], r[4], om[4];
    bytes_to_limbs(raw, r_bytes);
    to_mont(r, raw, FR);
    sub_mod(om, FR.one, r, FR);
    const size_t t = st->t_size;
    for (size_t i = 0; i < st->addr.size(); i++) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (t >= 16384)
#endif
        for (long long j = 0; j < (long long)t; j++) {
            u64 a = st->addr[i][j];
            mmul(&st->A[i][4 * j], &st->A[i][4 * j], (a & 1) ? r : om, FR);
            st->addr[i][j] = a >> 1;
        }
    }
    for (auto &T : st->kt) {
        size_t half = T.size() / 8;
        std::vector<u64> nxt(4 * half);
        for (size_t m = 0; m < half; m++) {
            u64 d[4];
            sub_mod(d, &T[8 * m + 4], &T[8 * m], FR);
            mmul(d, r, d, FR);
            add_mod(&nxt[4 * m], &T[8 * m], d, FR);
        }
        T.swap(nxt);
    }
    st->round++;
}

void sbk_free(int id) {
    if (id >= 0 && id < (int)g_sbk_store.size() && g_sbk_store[id]) {
        delete g_sbk_store[id];
        g_sbk_store[id] = nullptr;
    }
}

}  // extern "C"

// ---- batched column helpers for the bit-column provers ----

extern "C" {

// out: size * 32 B standard form — sum_i gamma^i * tables[i] pointwise
// (the gamma-RLC table feeding the batched PST openings,
// tnsh/protocols/sound.py::_rlc_tables).
void fr_rlc(const uint8_t *tables, size_t n_tabs, size_t size,
            const uint8_t *gamma, uint8_t *out) {
    u64 graw[4], g[4];
    bytes_to_limbs(graw, gamma);
    to_mont(g, graw, FR);
    std::vector<u64> w(4 * n_tabs);
    memcpy(&w[0], FR.one, 32);
    for (size_t i = 1; i < n_tabs; i++)
        mmul(&w[4 * i], &w[4 * (i - 1)], g, FR);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (size >= 4096)
#endif
    for (long long j = 0; j < (long long)size; j++) {
        u64 acc[4] = {0, 0, 0, 0};
        for (size_t t = 0; t < n_tabs; t++) {
            u64 raw[4], v[4];
            bytes_to_limbs(raw, tables + 32 * (t * size + j));
            to_mont(v, raw, FR);
            mmul(v, v, &w[4 * t], FR);
            add_mod(acc, acc, v, FR);
        }
        u64 s[4];
        from_mont(s, acc, FR);
        limbs_to_bytes(out + 32 * j, s);
    }
}

// out: n_tabs * 32 B standard form — multilinear evaluations of each table
// at ``point`` (variable 0 folded first, matching sound.py::_mle_eval).
void fr_mle_eval_many(const uint8_t *tables, size_t n_tabs, size_t size,
                      const uint8_t *point, size_t n_vars, uint8_t *out) {
    std::vector<u64> pt(4 * n_vars);
    for (size_t v = 0; v < n_vars; v++) {
        u64 raw[4];
        bytes_to_limbs(raw, point + 32 * v);
        to_mont(&pt[4 * v], raw, FR);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1) if (n_tabs > 1)
#endif
    for (long long t = 0; t < (long long)n_tabs; t++) {
        std::vector<u64> buf(4 * size);
        for (size_t i = 0; i < size; i++) {
            u64 raw[4];
            bytes_to_limbs(raw, tables + 32 * (t * size + i));
            to_mont(&buf[4 * i], raw, FR);
        }
        size_t cur = size;
        for (size_t v = 0; v < n_vars && cur > 1; v++) {
            size_t half = cur / 2;
            for (size_t i = 0; i < half; i++) {
                u64 d[4];
                sub_mod(d, &buf[8 * i + 4], &buf[8 * i], FR);
                mmul(d, &pt[4 * v], d, FR);
                add_mod(&buf[4 * i], &buf[8 * i], d, FR);
            }
            cur = half;
        }
        u64 s[4];
        from_mont(s, &buf[0], FR);
        limbs_to_bytes(out + 32 * t, s);
    }
}

}  // extern "C"
