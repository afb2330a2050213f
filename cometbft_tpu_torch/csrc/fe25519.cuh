// GF(2^255 - 19) and edwards25519 device functions.
//
// Radix 2^25.5: ten limbs of alternately 26 and 25 bits, stored as
// int32, multiplied 32 x 32 -> 64 bits with int64 sums. This is the
// arithmetic of cometbft_tpu_torch/ops/fe25519.py and curve25519.py,
// operation for operation: the same 100 partial products (a square
// sums the same columns from 55), the same parallel carry rounds (3
// after a multiply, 1 after add/sub/neg, with 2p added before a
// subtraction), the same point formulas. Integer arithmetic is exact,
// so a kernel and its plain version agree limb for limb. The JAX
// package (cometbft_tpu/ops/fe25519.py) uses 20 x 13 bits because the
// TPU has no 64-bit integers.
//
// What bounds these kernels: the integer multiply-add rate, and at
// small widths the latency of one lane's chain of dependent field
// operations. Every field operation is inlined with its operands by
// reference, so the ten independent column sums of a multiply, and
// the multiplies of a point operation that do not depend on each
// other, issue back to back; nothing is called through the ABI. A
// square has its own 55-product body: each off-diagonal product is
// taken once against the doubled operand, which gives the int64
// column sums of fe_mul(a, a) exactly, hence the same limbs. K1
// spreads a point operation over four threads (ladder.cu); the
// formulas here are the one-thread forms the rest of the code uses.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define NL 10

struct Fe { int32_t v[NL]; };
struct Ext { Fe X, Y, Z, T; };      // extended: x = X/Z, y = Y/Z, xy = T/Z
struct Proj { Fe X, Y, Z; };        // T-less

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

// fe_sub(a, b) where sub, else fe_add(a, b): the same sums, limb for limb
__device__ __forceinline__ Fe fe_addsub(const Fe& a, const Fe& b, bool sub) {
    Fe r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + (sub ? two_p(i) - b.v[i] : b.v[i]);
    return fe_carry1(r);
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) {
    Fe r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.v[i] = two_p(i) - a.v[i];
    return fe_carry1(r);
}

// The three parallel carry rounds after a product, on its column sums.
// The values are those of three rounds on 64 bits throughout; only the
// width differs: whatever the sums, after the first round every limb
// is below 2^44 and after the second below 2^27, so the second round's
// carries and the third round fit in 32 bits.
__device__ __forceinline__ Fe fe_carry3(const uint64_t t[NL]) {
    uint64_t u[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) u[i] = t[i] & ((1u << fe_width(i)) - 1);
    u[0] += 19 * (t[NL - 1] >> fe_width(NL - 1));
#pragma unroll
    for (int i = 1; i < NL; ++i) u[i] += t[i - 1] >> fe_width(i - 1);
    Fe x;
#pragma unroll
    for (int i = 0; i < NL; ++i) x.v[i] = (int32_t)((uint32_t)u[i] & ((1u << fe_width(i)) - 1));
    x.v[0] += 19 * (int32_t)(u[NL - 1] >> fe_width(NL - 1));
#pragma unroll
    for (int i = 1; i < NL; ++i) x.v[i] += (int32_t)(u[i - 1] >> fe_width(i - 1));
    return fe_carry1(x);
}

// out[k] = sum a_i b_j, weight 2 for odd x odd, 19 when i + j >= 10;
// then three parallel carry rounds on the sums. Limbs are nonnegative
// (the invariant of ops/fe25519.py), so the products are taken
// unsigned: one IMAD.WIDE.U32 each, where a signed 32 x 32 -> 64
// product costs the compiler three instructions.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
    uint32_t a1[NL], a2[NL], b1[NL], b19[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        a1[i] = (uint32_t)a.v[i];
        a2[i] = (i & 1) ? 2 * a1[i] : a1[i];
        b1[i] = (uint32_t)b.v[i];
        b19[i] = 19 * b1[i];
    }
    uint64_t t[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
            const uint32_t ai = ((i & 1) && (j & 1)) ? a2[i] : a1[i];
            if (i + j < NL)
                t[i + j] += (uint64_t)ai * b1[j];
            else
                t[i + j - NL] += (uint64_t)ai * b19[j];
        }
    }
    return fe_carry3(t);
}

// fe_mul(a, a) from 55 products: the diagonal once, each pair i < j
// once with the symmetric weight 2 folded into the left operand (4a_i
// where both limbs are odd); the column sums are fe_mul's exactly.
// Carried limbs keep 4a_i below 2^28 and 19a_j below 2^31.
__device__ __forceinline__ Fe fe_sq(const Fe& a) {
    uint32_t a1[NL], a2[NL], a4[NL], a19[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        a1[i] = (uint32_t)a.v[i];
        a2[i] = 2 * a1[i];
        a4[i] = 4 * a1[i];
        a19[i] = 19 * a1[i];
    }
    uint64_t t[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
#pragma unroll
        for (int j = i; j < NL; ++j) {
            const uint32_t l = i == j ? ((i & 1) ? a2[i] : a1[i])
                                      : (((i & 1) && (j & 1)) ? a4[i] : a2[i]);
            if (i + j < NL)
                t[i + j] += (uint64_t)l * a1[j];
            else
                t[i + j - NL] += (uint64_t)l * a19[j];
        }
    }
    return fe_carry3(t);
}

__device__ __forceinline__ Fe fe_sqn(Fe x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = fe_sq(x);
    return x;
}

// x^((p-5)/8) = x^(2^252 - 3)
__device__ __forceinline__ Fe fe_pow2523(const Fe& x) {
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
__device__ __forceinline__ Fe fe_canonical(Fe x) {
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

// projective addition (add-2008-bbjlp), reads no T
__device__ __forceinline__ Proj pt_add_projective(const Proj& p, const Proj& q) {
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

// --- launch facts, for the *_info entries

// info: registers, static and dynamic shared bytes, local (stack) bytes,
// resident blocks per SM and threads a block of `kernel` launched with
// `threads` threads and `smem_bytes` of dynamic shared memory
template <class Kernel>
int kernel_info(Kernel kernel, int threads, int smem_bytes, int* info) {
    cudaFuncAttributes fa;
    int blocks = 0;
    cudaFuncGetAttributes(&fa, kernel);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem_bytes);
    info[0] = fa.numRegs;
    info[1] = (int)fa.sharedSizeBytes;
    info[2] = smem_bytes;
    info[3] = (int)fa.localSizeBytes;
    info[4] = blocks;
    info[5] = threads;
    return (int)cudaGetLastError();
}
