// K2: ZIP-215 point decompression, one thread per lane.
//
// Replaces the JAX package's XLA stage cometbft_tpu/ops/curve25519.py::
// decompress (with fe25519.pow2523). Plain version:
// cometbft_tpu_torch/ops/curve25519.py::decompress_plain.
//
// Liberal decoding: y >= p is accepted (kept unreduced, later ops
// reduce it), x = 0 with the sign bit set is accepted (x = -0 = 0).
// Invalid lanes (u/v not a square) get ok = 0 and the identity.
//
// Bound: integer multiply-adds. ~270 field operations per lane, 251 of
// them squares in the sequential pow2523 chain; lanes are independent,
// so the card is filled by lane count, not by chain depth. The chain
// runs on the inlined 55-product square (fe25519.cuh) with the
// multiplies around it inlined too. In plain mode one launch covers
// the public keys and the R points together: 9,480 points for a
// 32-height window of 150-validator commits, which blocks of 64
// threads spread over all 132 SMs of an H100.
#include "fe25519.cuh"

constexpr int THREADS = 64;  // threads a block

__global__ void __launch_bounds__(THREADS)
decompress_kernel(const uint8_t* __restrict__ in, int ld_in, int n,
                  int32_t* __restrict__ out, int ld_out, uint8_t* __restrict__ ok_out) {
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= n) return;
    uint8_t b[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) b[k] = in[(size_t)k * ld_in + lane];
    const int32_t sign = b[31] >> 7;
    b[31] &= 0x7F;
    Fe y;
    int off = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
        y.v[i] = (int32_t)pack_limb(b, 32, off, fe_width(i), i == NL - 1);
        off += fe_width(i);
    }
    const Fe one = fe_const(1);
    const Fe ysq = fe_sq(y);
    const Fe u = fe_sub(ysq, one);
    const Fe v = fe_add(fe_mul(ysq, fe_d()), one);
    const Fe v3 = fe_mul(fe_sq(v), v);
    const Fe v7 = fe_mul(fe_sq(v3), v);
    const Fe r = fe_mul(fe_mul(u, v3), fe_pow2523(fe_mul(u, v7)));
    const Fe check = fe_mul(v, fe_sq(r));
    const bool root_ok = fe_eq(check, u);
    const bool root_neg = fe_eq(check, fe_neg(u));
    const bool ok = root_ok || root_neg;
    Fe x = root_neg ? fe_mul(r, fe_sqrtm1()) : r;
    if (fe_parity(x) != sign) x = fe_neg(x);
    Ext p;
    if (ok) {
        p = Ext{x, y, one, fe_mul(x, y)};
    } else {
        p = pt_identity();
    }
    store_fe(out, 0, ld_out, lane, p.X);
    store_fe(out, 1, ld_out, lane, p.Y);
    store_fe(out, 2, ld_out, lane, p.Z);
    store_fe(out, 3, ld_out, lane, p.T);
    ok_out[lane] = ok ? 1 : 0;
}

// in: (32, ld_in) uint8 encodings, lanes [0, n); out: (4, 10, ld_out)
// int32 extended points; ok: (n,) bytes
extern "C" int decompress_launch(const uint8_t* in, int ld_in, int n, int32_t* out,
                                 int ld_out, uint8_t* ok, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    decompress_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(in, ld_in, n, out,
                                                                    ld_out, ok);
    return (int)cudaGetLastError();
}

// launch facts, as kernel_info (fe25519.cuh) gives them (no dynamic
// shared memory)
extern "C" int decompress_info(int* info) {
    return kernel_info(decompress_kernel, THREADS, 0, info);
}
