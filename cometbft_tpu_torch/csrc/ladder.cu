// K1: the joint Straus ladder [s]B + [-h]A, and the fused verify epilogue.
//
// Replaces the JAX package's Pallas kernel cometbft_tpu/ops/
// pallas_ladder.py::_ladder_kernel (launched by _ladder_call, wrapped by
// straus_pallas with its A-table build) and its XLA twins
// ops/ed25519.py::_straus / _straus_compact. Plain versions:
// cometbft_tpu_torch/ops/ladder.py::straus_plain and verify_plain.
//
// Per lane (one thread): build cached([d]A), d = 0..15, from the
// extended A by 15 complete adds, as straus_pallas does before its
// pallas_call; then 64 windows top down, each 4 doubles (only the last
// computes T), one cached add from the lane's A table and one
// cached-affine add from the shared [d]B table in __constant__ memory.
// The FUSED entry continues with the epilogue of _verify_core:
// add_projective(q, -R), [8], is_identity, AND ok_a & ok_r & ok_s, and
// writes one verdict byte per lane.
//
// Bound: integer multiply-adds. ~2.8k field multiplies per lane in
// the windows, ~150 in the table build. The lane's A table (16 x 4 x
// 10 int32 = 2.5 KB) fits neither registers nor, for a block of lanes,
// shared memory, so it lives in a global scratch laid out
// [entry][coord][limb][lane]: each thread writes and reads only its
// own lane, neighbouring threads touch neighbouring words, and the
// 64 reads per lane mostly hit L1/L2. The digit lookup is a direct
// indexed load: verification handles public data, so the Pallas
// kernel's constant-time select tree (a Mosaic workaround) is gone.
#include "fe25519.cuh"

__constant__ int32_t BTAB[16][3][NL];

__device__ __forceinline__ void store_cached(int32_t* table, int d, int n, int lane,
                                             const Cached& c) {
    store_fe(table, d * 4 + 0, n, lane, c.ypx);
    store_fe(table, d * 4 + 1, n, lane, c.ymx);
    store_fe(table, d * 4 + 2, n, lane, c.Z);
    store_fe(table, d * 4 + 3, n, lane, c.t2d);
}

__device__ __forceinline__ Cached load_cached(const int32_t* table, int d, int n, int lane) {
    return Cached{load_fe(table, d * 4 + 0, n, lane), load_fe(table, d * 4 + 1, n, lane),
                  load_fe(table, d * 4 + 2, n, lane), load_fe(table, d * 4 + 3, n, lane)};
}

__device__ __forceinline__ AffCached load_btab(int d) {
    AffCached c;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        c.ypx.v[l] = BTAB[d][0][l];
        c.ymx.v[l] = BTAB[d][1][l];
        c.t2d.v[l] = BTAB[d][2][l];
    }
    return c;
}

template <bool FUSED>
__global__ void __launch_bounds__(128)
ladder_kernel(const uint8_t* __restrict__ ds, const uint8_t* __restrict__ dh, int n,
              const int32_t* __restrict__ A, int ld_a, const int32_t* __restrict__ R, int ld_r,
              const uint8_t* __restrict__ ok_a, const uint8_t* __restrict__ ok_r,
              const uint8_t* __restrict__ ok_s, int32_t* __restrict__ table,
              int32_t* __restrict__ out, uint8_t* __restrict__ verdict) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const Ext a{load_fe(A, 0, ld_a, lane), load_fe(A, 1, ld_a, lane), load_fe(A, 2, ld_a, lane),
                load_fe(A, 3, ld_a, lane)};
    Ext acc = pt_identity();
    store_cached(table, 0, n, lane, pt_to_cached(acc));
#pragma unroll 1
    for (int d = 1; d < 16; ++d) {
        acc = pt_add(acc, a);
        store_cached(table, d, n, lane, pt_to_cached(acc));
    }
    Proj q{fe_const(0), fe_const(1), fe_const(1)};
#pragma unroll 1
    for (int i = 0; i < 64; ++i) {
        const int j = 63 - i;
        const Ext e = pt_dbl_ext(pt_dbl(pt_dbl(pt_dbl(q))));
        const Ext e2 = pt_add_cached(e, load_cached(table, dh[(size_t)j * n + lane], n, lane));
        q = pt_add_affine_cached(e2, load_btab(ds[(size_t)j * n + lane]));
    }
    if (!FUSED) {
        store_fe(out, 0, n, lane, q.X);
        store_fe(out, 1, n, lane, q.Y);
        store_fe(out, 2, n, lane, q.Z);
        return;
    }
    const Proj negR{fe_neg(load_fe(R, 0, ld_r, lane)), load_fe(R, 1, ld_r, lane),
                    load_fe(R, 2, ld_r, lane)};
    const Proj p8 = pt_dbl(pt_dbl(pt_dbl(pt_add_projective(q, negR))));
    const bool ok = ok_a[lane] && ok_r[lane] && ok_s[lane] && pt_is_identity(p8);
    verdict[lane] = ok ? 1 : 0;
}

// host table (16, 3, 10) int32 -> __constant__ (once per loaded library)
extern "C" int ladder_set_btable(const int32_t* host) {
    cudaMemcpyToSymbol(BTAB, host, sizeof(BTAB));
    return (int)cudaGetLastError();
}

static int blocks_for(int n) { return (n + 127) / 128; }

// ds, dh (64, n) uint8 digits; A (4, 10, ld_a) int32; table scratch
// (16, 4, 10, n) int32; out (3, 10, n) int32
extern "C" int straus_launch(const uint8_t* ds, const uint8_t* dh, int n, const int32_t* A,
                             int ld_a, int32_t* table, int32_t* out, void* stream) {
    ladder_kernel<false><<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
        ds, dh, n, A, ld_a, nullptr, 0, nullptr, nullptr, nullptr, table, out, nullptr);
    return (int)cudaGetLastError();
}

// as straus_launch, plus R (4, 10, ld_r) int32 and ok_a, ok_r, ok_s (n,)
// bytes; writes verdict (n,) bytes
extern "C" int verify_launch(const uint8_t* ds, const uint8_t* dh, int n, const int32_t* A,
                             int ld_a, const int32_t* R, int ld_r, const uint8_t* ok_a,
                             const uint8_t* ok_r, const uint8_t* ok_s, int32_t* table,
                             uint8_t* verdict, void* stream) {
    ladder_kernel<true><<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
        ds, dh, n, A, ld_a, R, ld_r, ok_a, ok_r, ok_s, table, nullptr, verdict);
    return (int)cudaGetLastError();
}
