// GF(2^255 - 19) and edwards25519 device functions, one thread per lane.
//
// Radix 2^25.5: ten limbs of alternately 26 and 25 bits, stored as
// int32, multiplied 32 x 32 -> 64 bits with int64 sums. This is the
// arithmetic of cometbft_tpu_torch/ops/fe25519.py and curve25519.py,
// operation for operation: the same 100 partial products, the same
// parallel carry rounds (3 after a multiply, 1 after add/sub/neg, with
// 2p added before a subtraction), the same point formulas. Integer
// arithmetic is exact, so a kernel and its plain version agree limb
// for limb. The JAX package (cometbft_tpu/ops/fe25519.py) uses 20 x 13
// bits because the TPU has no 64-bit integers.
//
// What bounds these kernels: the integer multiply-add rate. A field
// multiply is 100 IMAD.WIDE plus ~60 carry instructions; verification
// costs ~3.3k field multiplies per signature in precomp mode. The
// design keeps everything in registers per thread (one lane per
// thread, no shared memory) and keeps the multiply out of line
// (__noinline__) so the ladder compiles in seconds; making it fast
// (a dedicated square, inlining, table placement) is later work.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define NL 10

struct Fe { int32_t v[NL]; };
struct Ext { Fe X, Y, Z, T; };      // extended: x = X/Z, y = Y/Z, xy = T/Z
struct Proj { Fe X, Y, Z; };        // T-less
struct Cached { Fe ypx, ymx, Z, t2d; };
struct AffCached { Fe ypx, ymx, t2d; };

__device__ __forceinline__ constexpr int fe_width(int i) { return (i & 1) ? 25 : 26; }

// 2p with every limb above the carried bound (ops/fe25519.py TWO_P)
__device__ __forceinline__ int32_t two_p(int i) {
    return i == 0 ? (1 << 27) - 38 : (i & 1) ? (1 << 26) - 2 : (1 << 27) - 2;
}

// d, 2d, sqrt(-1) as canonical limbs (generated from ops/fe25519.to_limbs)
__device__ __forceinline__ Fe fe_d() {
    return Fe{{56195235, 13857412, 51736253, 6949390, 114729, 24766616,
               60832955, 30306712, 48412415, 21499315}};
}
__device__ __forceinline__ Fe fe_d2() {
    return Fe{{45281625, 27714825, 36363642, 13898781, 229458, 15978800,
               54557047, 27058993, 29715967, 9444199}};
}
__device__ __forceinline__ Fe fe_sqrtm1() {
    return Fe{{34513072, 25610706, 9377949, 3500415, 12389472, 33281959,
               41962654, 31548777, 326685, 11406482}};
}

__device__ __forceinline__ Fe fe_const(int32_t c) {
    Fe r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.v[i] = 0;
    r.v[0] = c;
    return r;
}

// one parallel carry round on int32 limbs (inputs below 2^30)
__device__ __forceinline__ Fe fe_carry1(Fe x) {
    int32_t c[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        c[i] = x.v[i] >> fe_width(i);
        x.v[i] &= (1 << fe_width(i)) - 1;
    }
    x.v[0] += 19 * c[NL - 1];
#pragma unroll
    for (int i = 1; i < NL; ++i) x.v[i] += c[i - 1];
    return x;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + b.v[i];
    return fe_carry1(r);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + two_p(i) - b.v[i];
    return fe_carry1(r);
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) {
    Fe r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.v[i] = two_p(i) - a.v[i];
    return fe_carry1(r);
}

// out[k] = sum a_i b_j, weight 2 for odd x odd, 19 when i + j >= 10;
// then three parallel carry rounds on the int64 sums
__device__ __noinline__ Fe fe_mul(const Fe a, const Fe b) {
    int32_t a2[NL], b19[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        a2[i] = (i & 1) ? 2 * a.v[i] : a.v[i];
        b19[i] = 19 * b.v[i];
    }
    int64_t t[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            const int32_t ai = ((i & 1) && (j & 1)) ? a2[i] : a.v[i];
            if (i + j < NL)
                t[i + j] += (int64_t)ai * b.v[j];
            else
                t[i + j - NL] += (int64_t)ai * b19[j];
        }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        int64_t c[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
            c[i] = t[i] >> fe_width(i);
            t[i] &= (1LL << fe_width(i)) - 1;
        }
        t[0] += 19 * c[NL - 1];
#pragma unroll
        for (int i = 1; i < NL; ++i) t[i] += c[i - 1];
    }
    Fe out;
#pragma unroll
    for (int i = 0; i < NL; ++i) out.v[i] = (int32_t)t[i];
    return out;
}

__device__ __forceinline__ Fe fe_sq(const Fe& a) { return fe_mul(a, a); }

__device__ Fe fe_sqn(Fe x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = fe_sq(x);
    return x;
}

// x^((p-5)/8) = x^(2^252 - 3)
__device__ Fe fe_pow2523(const Fe& x) {
    Fe x2 = fe_sq(x);
    Fe x9 = fe_mul(fe_sqn(x2, 2), x);
    Fe x11 = fe_mul(x9, x2);
    Fe x_5_0 = fe_mul(fe_sq(x11), x9);
    Fe x_10_0 = fe_mul(fe_sqn(x_5_0, 5), x_5_0);
    Fe x_20_0 = fe_mul(fe_sqn(x_10_0, 10), x_10_0);
    Fe x_40_0 = fe_mul(fe_sqn(x_20_0, 20), x_20_0);
    Fe x_50_0 = fe_mul(fe_sqn(x_40_0, 10), x_10_0);
    Fe x_100_0 = fe_mul(fe_sqn(x_50_0, 50), x_50_0);
    Fe x_200_0 = fe_mul(fe_sqn(x_100_0, 100), x_100_0);
    Fe x_250_0 = fe_mul(fe_sqn(x_200_0, 50), x_50_0);
    return fe_mul(fe_sqn(x_250_0, 2), x);
}

// fully reduced limbs of x mod p (ops/fe25519.canonical)
__device__ Fe fe_canonical(Fe x) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int i = 0; i < NL; ++i) {
            const int32_t hi = x.v[i] >> fe_width(i);
            x.v[i] &= (1 << fe_width(i)) - 1;
            if (i < NL - 1) x.v[i + 1] += hi;
            else x.v[0] += 19 * hi;
        }
    }
    int32_t q = (x.v[0] + 19) >> fe_width(0);
#pragma unroll
    for (int i = 1; i < NL; ++i) q = (x.v[i] + q) >> fe_width(i);
    x.v[0] += 19 * q;
#pragma unroll
    for (int i = 0; i < NL - 1; ++i) {
        const int32_t hi = x.v[i] >> fe_width(i);
        x.v[i] &= (1 << fe_width(i)) - 1;
        x.v[i + 1] += hi;
    }
    x.v[NL - 1] &= (1 << fe_width(NL - 1)) - 1;
    return x;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& x) {
    const Fe c = fe_canonical(x);
    int32_t acc = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) acc |= c.v[i];
    return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
    return fe_is_zero(fe_sub(a, b));
}

__device__ __forceinline__ int32_t fe_parity(const Fe& x) {
    return fe_canonical(x).v[0] & 1;
}

// little-endian bytes -> limb of `width` bits starting at bit `off`
__device__ __forceinline__ int64_t pack_limb(const uint8_t* b, int nbytes,
                                             int off, int width, bool rest) {
    const int hi_bit = rest ? nbytes * 8 : off + width;
    int64_t v = 0;
    for (int k = off / 8; k <= (hi_bit - 1) / 8; ++k) {
        const int sh = 8 * k - off;
        v += sh >= 0 ? ((int64_t)b[k] << sh) : ((int64_t)b[k] >> -sh);
    }
    return rest ? v : (v & ((1LL << width) - 1));
}

// --- group law (ops/curve25519.py) -------------------------------------

__device__ __forceinline__ Ext pt_identity() {
    Ext p;
    p.X = fe_const(0); p.Y = fe_const(1); p.Z = fe_const(1); p.T = fe_const(0);
    return p;
}

__device__ Ext pt_add(const Ext& p, const Ext& q) {
    const Fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    const Fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    const Fe C = fe_mul(fe_mul(p.T, fe_d2()), q.T);
    const Fe ZZ = fe_mul(p.Z, q.Z);
    const Fe Dv = fe_add(ZZ, ZZ);
    const Fe E = fe_sub(B, A), F = fe_sub(Dv, C), G = fe_add(Dv, C), H = fe_add(B, A);
    return Ext{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

// doubling (dbl-2008-hwcd); the T-less form skips one multiply
__device__ Proj pt_dbl_core(const Fe& X1, const Fe& Y1, const Fe& Z1, Fe* E_out,
                            Fe* H_out) {
    const Fe A = fe_sq(X1);
    const Fe B = fe_sq(Y1);
    const Fe Zsq = fe_sq(Z1);
    const Fe C = fe_add(Zsq, Zsq);
    const Fe H = fe_add(A, B);
    const Fe E = fe_sub(H, fe_sq(fe_add(X1, Y1)));
    const Fe G = fe_sub(A, B);
    const Fe F = fe_add(C, G);
    *E_out = E;
    *H_out = H;
    return Proj{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G)};
}

__device__ __forceinline__ Proj pt_dbl(const Proj& p) {
    Fe E, H;
    return pt_dbl_core(p.X, p.Y, p.Z, &E, &H);
}

__device__ __forceinline__ Ext pt_dbl_ext(const Proj& p) {
    Fe E, H;
    const Proj r = pt_dbl_core(p.X, p.Y, p.Z, &E, &H);
    return Ext{r.X, r.Y, r.Z, fe_mul(E, H)};
}

__device__ __forceinline__ Cached pt_to_cached(const Ext& p) {
    return Cached{fe_add(p.Y, p.X), fe_sub(p.Y, p.X), p.Z, fe_mul(p.T, fe_d2())};
}

__device__ Ext pt_add_cached(const Ext& p, const Cached& c) {
    const Fe A = fe_mul(fe_sub(p.Y, p.X), c.ymx);
    const Fe B = fe_mul(fe_add(p.Y, p.X), c.ypx);
    const Fe C = fe_mul(p.T, c.t2d);
    const Fe ZZ = fe_mul(p.Z, c.Z);
    const Fe Dv = fe_add(ZZ, ZZ);
    const Fe E = fe_sub(B, A), F = fe_sub(Dv, C), G = fe_add(Dv, C), H = fe_add(B, A);
    return Ext{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

// extended + cached affine (Z2 = 1), T output not computed
__device__ Proj pt_add_affine_cached(const Ext& p, const AffCached& c) {
    const Fe A = fe_mul(fe_sub(p.Y, p.X), c.ymx);
    const Fe B = fe_mul(fe_add(p.Y, p.X), c.ypx);
    const Fe C = fe_mul(p.T, c.t2d);
    const Fe Dv = fe_add(p.Z, p.Z);
    const Fe E = fe_sub(B, A), F = fe_sub(Dv, C), G = fe_add(Dv, C), H = fe_add(B, A);
    return Proj{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G)};
}

// projective addition (add-2008-bbjlp), reads no T
__device__ Proj pt_add_projective(const Proj& p, const Proj& q) {
    const Fe A = fe_mul(p.Z, q.Z);
    const Fe B = fe_sq(A);
    const Fe C = fe_mul(p.X, q.X);
    const Fe Dv = fe_mul(p.Y, q.Y);
    const Fe E = fe_mul(fe_mul(fe_d(), C), Dv);
    const Fe F = fe_sub(B, E);
    const Fe G = fe_add(B, E);
    const Fe X3 = fe_mul(fe_mul(A, F),
                         fe_sub(fe_mul(fe_add(p.X, p.Y), fe_add(q.X, q.Y)), fe_add(C, Dv)));
    const Fe Y3 = fe_mul(fe_mul(A, G), fe_add(Dv, C));
    return Proj{X3, Y3, fe_mul(F, G)};
}

__device__ __forceinline__ bool pt_is_identity(const Proj& p) {
    return fe_is_zero(p.X) && fe_is_zero(fe_sub(p.Y, p.Z));
}

// --- lane-major global memory: element (c, l) of lane at [(c*NL + l)*ld + lane]

__device__ __forceinline__ Fe load_fe(const int32_t* base, int c, int ld, int lane) {
    Fe r;
#pragma unroll
    for (int l = 0; l < NL; ++l) r.v[l] = base[(size_t)(c * NL + l) * ld + lane];
    return r;
}

__device__ __forceinline__ void store_fe(int32_t* base, int c, int ld, int lane, const Fe& x) {
#pragma unroll
    for (int l = 0; l < NL; ++l) base[(size_t)(c * NL + l) * ld + lane] = x.v[l];
}
