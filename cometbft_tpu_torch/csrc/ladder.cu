// K1: the joint Straus ladder [s]B + [-h]A, and the fused verify epilogue.
//
// Replaces the JAX package's Pallas kernel cometbft_tpu/ops/
// pallas_ladder.py::_ladder_kernel (launched by _ladder_call, wrapped by
// straus_pallas with its A-table build) and its XLA twins
// ops/ed25519.py::_straus / _straus_compact. Plain versions:
// cometbft_tpu_torch/ops/ladder.py::straus_plain and verify_plain.
//
// Per lane: build cached([d]A), d = 0..15, from the extended A by 15
// complete adds, as straus_pallas does before its pallas_call; then 64
// windows top down, each 4 doubles (only the last computes T), one
// cached add from the lane's A table and one cached-affine add from the
// shared [d]B table. The FUSED entry continues with the epilogue of
// _verify_core: add_projective(q, -R), [8], is_identity, AND ok_a &
// ok_r & ok_s, and writes one verdict byte per lane.
//
// What bounds it: the 32 x 32 -> 64 multiply-adds (IMAD.WIDE.U32), and
// at the main path's small widths the latency of a lane's ~2.9k
// dependent field operations. So a lane runs on four threads, a
// "quad": the extended-coordinate formulas (Hisil-Wong-Carter-Dawson
// 2008) have four independent products per round, and thread
// r = threadIdx.x & 3 takes one. Between rounds rank r holds
// coordinate r of (X, T, Z, Y), and the rounds are
//   doubling     X^2, (X+Y)^2, 2Z^2, Y^2       then  E*F, E*H, G*F, G*H
//   cached add   (Y-X)*ymx, T*t2d, 2Z*Z2, (Y+X)*ypx   then the same four
//   affine add   as the cached add, rank 2 giving D = 2Z (Z2 = 1)
// so a window is 12 multiply rounds instead of ~43 dependent
// operations. Each of E, F, G, H is formed by one rank with the
// sequential formulas' fe_add/fe_sub on the same operands, so the
// limbs are the sequential ones. Values move through a per-quad
// shared-memory slot: three stores (16, 16 and 8 bytes) between two
// __syncwarp, then loads at slot indices chosen by rank. The four
// ranks run one instruction stream with no branch on the rank: a warp
// issues, each round, what its busiest rank needs. (Four warps of one rank each,
// meeting at a named barrier, issue less in all but wait for the
// busiest warp every round; on an H100 that was slower at every width.)
// The whole warp meets at the __syncwarp: every thread is alive and
// takes the same path (a quad past the last lane repeats lane n-1 and
// stores nothing), and a full-warp __syncwarp costs no instruction of
// its own where a per-quad mask cost a MATCH.ANY and a branch a round.
//
// Tables. Thread r keeps coordinate r of every cached([d]A) in shared
// memory, the one its first product of a cached add multiplies by
// (ymx, t2d, Z, ypx), so a table read needs no exchange; the layout
// [entry][word][thread] keeps a warp's reads on distinct banks
// whatever its digits. The [d]B table is copied once per block from
// device memory into shared memory, in the same rank order. Nothing is
// kept in device memory besides the inputs and the output. The digit
// lookup is a direct indexed load: verification handles public data,
// so the Pallas kernel's constant-time select tree (a Mosaic
// workaround) is gone.
#include "fe25519.cuh"

__device__ int32_t BTAB[16][3][NL];  // cached-affine [d]B: ypx, ymx, t2d

// Shared memory holds an element of the exchange slots and of the [d]B
// table in two pieces, limbs 0-7 as two 16-byte words in a "wide" array
// and limbs 8-9 as one 8-byte word in a "narrow" one: three accesses,
// no padding. A quad's wide slots are 36 words apart, so the two quads
// of a 16-byte access phase use disjoint banks. The [d]A table is
// packed, 27 bits a limb in 9 words (see pack27). All of it keeps a
// 128-thread block at 76,672 bytes, so three fit on an SM (12 warps).
constexpr int WIDE = 8, NARROW = 2;         // words of an element's two pieces
constexpr int BTAB_N = 16 * 3;              // [d][ymx, t2d, ypx]
constexpr int QUAD_WIDE = 4 * WIDE + 4;     // a quad's wide slots, padded
constexpr int QUAD_NARROW = 4 * NARROW;
constexpr int PK_W = 9;                     // words of a packed table entry
constexpr int ATAB_WORDS = 15 * PK_W;       // per thread: cached([d]A), d = 1..15
// threads a block, four a lane (chosen from block sizes 32-128 timed on
// an H100: 128 was fastest at 131,072 lanes and no slower at 4,740)
constexpr int THREADS = 128;
constexpr size_t SMEM_BYTES = sizeof(int32_t) * (BTAB_N * (WIDE + NARROW) +
                                                 (THREADS / 4) * (QUAD_WIDE + QUAD_NARROW) +
                                                 THREADS * ATAB_WORDS);

// elements k = 0, 1, ... of an array of split elements
struct Slot {
    int32_t* w;  // wide pieces, WIDE words apart
    int32_t* n;  // narrow pieces, NARROW words apart
};

struct Quad {
    int r;        // rank in the quad
    Slot slot;    // the quad's exchange slots, one a rank
};

// A point between rounds: rank r holds coordinate r of X, T, Z, Y as
// its own product, and every rank holds X and Y (the next round's
// X + Y, Y - X and Y + X need them). `last` is the exchange slot the
// products were read from.
struct QPoint {
    Fe own, X, Y;
    Slot last;
};

// c ? a : b limb by limb, in registers
__device__ __forceinline__ Fe sel(bool c, const Fe& a, const Fe& b) {
    Fe o;
#pragma unroll
    for (int l = 0; l < NL; ++l) o.v[l] = c ? a.v[l] : b.v[l];
    return o;
}

// this thread's value into its slot, between two meetings of the warp:
// the first lets every rank finish reading the last round's values
__device__ __forceinline__ Slot put(const Quad& q, const Fe& mine) {
    __syncwarp();
    int4* w = reinterpret_cast<int4*>(q.slot.w + q.r * WIDE);
    w[0] = make_int4(mine.v[0], mine.v[1], mine.v[2], mine.v[3]);
    w[1] = make_int4(mine.v[4], mine.v[5], mine.v[6], mine.v[7]);
    *reinterpret_cast<int2*>(q.slot.n + q.r * NARROW) = make_int2(mine.v[8], mine.v[9]);
    __syncwarp();
    return q.slot;
}

// element k of split elements
__device__ __forceinline__ Fe get(const Slot& s, int k) {
    const int4* p = reinterpret_cast<const int4*>(s.w + k * WIDE);
    const int4 x = p[0], y = p[1];
    const int2 z = *reinterpret_cast<const int2*>(s.n + k * NARROW);
    return Fe{{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y}};
}

// A carried limb (the output of any fe_carry1 or fe_carry3) is below
// 2^26 + 2^11, so 27 bits hold it; limb l of a table entry sits at bit
// 27l of its 9 words, word i at dst[i * stride].
__device__ __forceinline__ void pack27(int32_t* dst, int stride, const Fe& v) {
    uint32_t w[PK_W];
#pragma unroll
    for (int i = 0; i < PK_W; ++i) w[i] = 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        const int i = 27 * l / 32, sh = 27 * l % 32;
        w[i] |= (uint32_t)v.v[l] << sh;
        if (sh > 5) w[i + 1] |= (uint32_t)v.v[l] >> (32 - sh);
    }
#pragma unroll
    for (int i = 0; i < PK_W; ++i) dst[i * stride] = (int32_t)w[i];
}

__device__ __forceinline__ Fe unpack27(const int32_t* src, int stride) {
    uint32_t w[PK_W];
#pragma unroll
    for (int i = 0; i < PK_W; ++i) w[i] = (uint32_t)src[i * stride];
    Fe v;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        const int i = 27 * l / 32, sh = 27 * l % 32;
        uint32_t x = w[i] >> sh;
        if (sh > 5) x |= w[i + 1] << (32 - sh);
        v.v[l] = (int32_t)(x & ((1u << 27) - 1));
    }
    return v;
}

// The second round of every point operation. Rank r gives v_r, the
// r-th of E, F, G, H, which it formed alone; then ranks 0-3 multiply
// E*F, E*H, G*F, G*H, reading their operands from the slot at indices
// chosen by rank, and hold X, T, Z, Y (F*G = G*F limb for limb: a
// product's column sums do not depend on the order of its operands).
__device__ __forceinline__ QPoint products(const Quad& q, const Fe& v_r) {
    const Slot s = put(q, v_r);
    const Fe m = fe_mul(get(s, q.r & 2), get(s, 1 + 2 * (q.r & 1)));
    const Slot t = put(q, m);
    return QPoint{m, get(t, 0), get(t, 3), t};
}

// E = B - A, F = D - C, G = D + C, H = B + A, rank r forming the r-th,
// from a slot holding A, C, D, B
__device__ __forceinline__ Fe efgh(const Quad& q, const Slot& s) {
    const bool ab = q.r == 0 || q.r == 3;
    return fe_addsub(get(s, ab ? 3 : 2), get(s, ab ? 0 : 1), q.r < 2);
}

// dbl-2008-hwcd (curve25519.double): X^2, (X+Y)^2, 2Z^2, Y^2 on ranks
// 0-3, each rank squaring its own coordinate but rank 1 (T is not
// read); then H = A + B, G = A - B (ranks 0 and 3, 1 and 2), E = H -
// (X+Y)^2 (rank 0), F = G + C (rank 1). T is computed as well.
__device__ __forceinline__ QPoint qdbl(const Quad& q, const QPoint& p) {
    const Fe sq = fe_sq(sel(q.r == 1, fe_add(p.X, p.Y), p.own));
    const Slot s = put(q, sel(q.r == 2, fe_add(sq, sq), sq));
    const Fe hg = fe_addsub(get(s, 0), get(s, 3), q.r == 1 || q.r == 2);
    const Fe ef = fe_addsub(hg, get(s, 1 + (q.r & 1)), q.r == 0);
    return products(q, sel(q.r < 2, ef, hg));
}

// p + cached c (curve25519.add_cached): (Y-X)*ymx, T*t2d, Z*Z2,
// (Y+X)*ypx on ranks 0-3, c_r being this rank's coordinate of c, rank
// 2 giving D = 2*Z*Z2. With AFFINE, p + cached-affine c
// (add_affine_cached, Z2 = 1, T not computed): rank 2 gives D = 2Z.
template <bool AFFINE>
__device__ __forceinline__ QPoint qadd(const Quad& q, const QPoint& p, const Fe& c_r) {
    const bool yx = q.r == 0 || q.r == 3;
    const Fe m = fe_mul(sel(yx, fe_addsub(p.Y, p.X, q.r == 0), p.own), c_r);
    const Fe d = AFFINE ? fe_add(p.own, p.own) : fe_add(m, m);
    return products(q, efgh(q, put(q, sel(q.r == 2, d, m))));
}

// three 128-thread blocks a SM, as many as shared memory holds: up to 170
// registers a thread (bounded by threads alone, ptxas held the fused entry
// to 128 registers and spilled)
template <bool FUSED>
__global__ void __launch_bounds__(THREADS, 3)
ladder_kernel(const uint8_t* __restrict__ ds, const uint8_t* __restrict__ dh, int n,
              const int32_t* __restrict__ A, int ld_a, const int32_t* __restrict__ R, int ld_r,
              const uint8_t* __restrict__ ok_a, const uint8_t* __restrict__ ok_r,
              const uint8_t* __restrict__ ok_s, int32_t* __restrict__ out,
              uint8_t* __restrict__ verdict) {
    extern __shared__ int4 smem4[];
    const int tid = threadIdx.x, nt = THREADS, quads = THREADS / 4;
    const Slot bt{reinterpret_cast<int32_t*>(smem4), reinterpret_cast<int32_t*>(smem4) + BTAB_N * WIDE};
    int32_t* const xw = bt.n + BTAB_N * NARROW;
    int32_t* const xn = xw + quads * QUAD_WIDE;
    // this thread's row of the packed A table: entry e, word i at [(e*PK_W + i)*nt]
    int32_t* const at = xn + quads * QUAD_NARROW + tid;

    // [d]B into shared memory: what ranks 0, 1, 3 multiply by (ymx,
    // t2d, ypx); rank 2 gives D and reads element 0 unused
    for (int w = tid; w < BTAB_N * NL; w += nt) {
        const int e = w / NL, l = w % NL, d = e / 3, k = e % 3;
        const int32_t x = BTAB[d][k == 0 ? 1 : k == 1 ? 2 : 0][l];
        if (l < WIDE) bt.w[e * WIDE + l] = x;
        else bt.n[e * NARROW + l - WIDE] = x;
    }
    __syncthreads();

    const Quad q{tid & 3, Slot{xw + (tid >> 2) * QUAD_WIDE, xn + (tid >> 2) * QUAD_NARROW}};
    const int bslot = q.r == 3 ? 2 : q.r & 1;
    const int quad = (blockIdx.x * nt + tid) >> 2;
    const bool active = quad < n;
    const int lane = active ? quad : n - 1;
    const Fe zero = fe_const(0), one = fe_const(1);
    // the identity (0, 1, 1, 0) as this rank holds it
    const QPoint ident{sel(q.r >= 2, one, zero), zero, one, Slot{}};

    // cached([d]A), d = 0..15: acc = d*A by pt_add(acc, A), whose first
    // round gives (Y-X)*(Y2-X2), T*2d (then *T2), Z*Z2 (then doubled),
    // (Y+X)*(Y2+X2); this rank keeps the factor it multiplies by in a
    // cached add: Y-X, T*2d (the t2d of cached(acc)), Z, Y+X. Entry 0,
    // cached(identity), is the same for every lane and stays in
    // registers; 1..15 go to this thread's row of the table.
    const Fe aX = load_fe(A, 0, ld_a, lane), aY = load_fe(A, 1, ld_a, lane),
             aZ = load_fe(A, 2, ld_a, lane), aT = load_fe(A, 3, ld_a, lane);
    const bool yx = q.r == 0 || q.r == 3;
    const Fe a_r = sel(yx, fe_addsub(aY, aX, q.r == 0), sel(q.r == 1, fe_d2(), aZ));
    QPoint acc = ident;
    Fe c0;
#pragma unroll 1
    for (int d = 0;; ++d) {
        const Fe in = sel(yx, fe_addsub(acc.Y, acc.X, q.r == 0), acc.own);
        const Fe m = fe_mul(in, a_r);
        const Fe mine = sel(q.r == 1, m, in);
        if (d == 0) {
            c0 = mine;
        } else {
            pack27(at + (d - 1) * PK_W * nt, nt, mine);
        }
        if (d == 15) break;
        // C = T*2d*T2 (rank 1), D = 2*Z*Z2 (rank 2)
        const Fe cd = sel(q.r == 1, fe_mul(m, aT), fe_add(m, m));
        acc = products(q, efgh(q, put(q, sel(q.r == 1 || q.r == 2, cd, m))));
    }

    // the digits are read one window ahead, the table entries at the
    // top of their window, so no load waits at the adds
    QPoint p = ident;
    int da = dh[(size_t)63 * n + lane], db = ds[(size_t)63 * n + lane];
#pragma unroll 1
    for (int j = 63; j >= 0; --j) {
        const int ea = da ? da - 1 : 0;
        const Fe ca = sel(da != 0, unpack27(at + ea * PK_W * nt, nt), c0);
        const Fe cb = get(bt, db * 3 + bslot);
        const int jn = j ? j - 1 : 0;
        da = dh[(size_t)jn * n + lane];
        db = ds[(size_t)jn * n + lane];
#pragma unroll 1
        for (int k = 0; k < 4; ++k) p = qdbl(q, p);
        p = qadd<false>(q, p, ca);
        p = qadd<true>(q, p, cb);
    }
    if (!FUSED) {
        // ranks 0, 3, 2 hold X, Y, Z
        if (active && q.r != 1) store_fe(out, q.r == 0 ? 0 : q.r == 3 ? 1 : 2, n, lane, p.own);
        return;
    }
    const Proj negR{fe_neg(load_fe(R, 0, ld_r, lane)), load_fe(R, 1, ld_r, lane),
                    load_fe(R, 2, ld_r, lane)};
    const Proj t = pt_add_projective(Proj{p.X, p.Y, get(p.last, 2)}, negR);
    p = QPoint{sel(q.r & 2, sel(q.r & 1, t.Y, t.Z), t.X), t.X, t.Y, Slot{}};
#pragma unroll 1
    for (int k = 0; k < 3; ++k) p = qdbl(q, p);
    const bool ok = ok_a[lane] && ok_r[lane] && ok_s[lane] &&
                    pt_is_identity(Proj{p.X, p.Y, get(p.last, 2)});
    if (active && q.r == 0) verdict[lane] = ok ? 1 : 0;
}

// once per loaded library: the [d]B table (16, 3, 10) int32 from the
// host, and the shared memory a block takes
extern "C" int ladder_init(const int32_t* host) {
    cudaMemcpyToSymbol(BTAB, host, sizeof(BTAB));
    const int smem = (int)SMEM_BYTES;
    cudaFuncSetAttribute(ladder_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(ladder_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(ladder_kernel<false>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(ladder_kernel<true>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return (int)cudaGetLastError();
}

static int blocks_for(int n) { return (int)((4L * n + THREADS - 1) / THREADS); }

// ds, dh (64, n) uint8 digits; A (4, 10, ld_a) int32; out (3, 10, n)
// int32
extern "C" int straus_launch(const uint8_t* ds, const uint8_t* dh, int n, const int32_t* A,
                             int ld_a, int32_t* out, void* stream) {
    ladder_kernel<false><<<blocks_for(n), THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        ds, dh, n, A, ld_a, nullptr, 0, nullptr, nullptr, nullptr, out, nullptr);
    return (int)cudaGetLastError();
}

// as straus_launch, plus R (4, 10, ld_r) int32 and ok_a, ok_r, ok_s (n,)
// bytes; writes verdict (n,) bytes
extern "C" int verify_launch(const uint8_t* ds, const uint8_t* dh, int n, const int32_t* A,
                             int ld_a, const int32_t* R, int ld_r, const uint8_t* ok_a,
                             const uint8_t* ok_r, const uint8_t* ok_s, uint8_t* verdict,
                             void* stream) {
    ladder_kernel<true><<<blocks_for(n), THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        ds, dh, n, A, ld_a, R, ld_r, ok_a, ok_r, ok_s, nullptr, verdict);
    return (int)cudaGetLastError();
}

// launch facts, as kernel_info (fe25519.cuh) gives them, of the fused
// (fused != 0) or bare entry
extern "C" int ladder_info(int fused, int* info) {
    return fused ? kernel_info(ladder_kernel<true>, THREADS, SMEM_BYTES, info)
                 : kernel_info(ladder_kernel<false>, THREADS, SMEM_BYTES, info);
}
