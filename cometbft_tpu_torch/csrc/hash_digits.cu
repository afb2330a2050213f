// K3: per-lane SHA-512(R || A || M), h mod L, -h mod L, window digits.
//
// Replaces the JAX package's XLA stages cometbft_tpu/ops/sha512.py::
// sha512 and cometbft_tpu/ops/sc25519.py::reduce_512, neg_mod_L,
// digits4, lt_L (and hash_bytes_to_limbs). Plain version:
// cometbft_tpu_torch/ops/sc25519.py::hash_digits_plain.
//
// SHA-512 runs on native 64-bit words (the JAX package splits them
// into uint32 halves because the TPU has no int64), one thread per
// lane. The reduction mod L is ref10's sc_reduce schedule on 21-bit
// limbs in int64.
//
// Bound: the compression's 32-bit instructions, at the least 3,568 a
// 128-byte block (chip_smoke.py::SHA_OPS_PER_BLOCK: a 64-bit rotate is
// two funnel shifts, a three-way XOR, choose or majority one LOP3 a
// half, a sum of three 64-bit words one IADD3 pair) — 1 to 8 blocks per
// lane — plus the message bytes read once. At small widths a lane's
// time is its chain of dependent rounds, so nothing else may wait on
// memory one load at a time: the block's threads copy each 128-byte SHA
// block of all their lanes into shared memory together, with loads
// that do not depend on each other (4 bytes of 4 lanes a load where the
// row allows it, else single bytes), transposed with byte permutes into
// one column of big-endian words per lane; columns are 33 words apart,
// so that neither the stores nor the reads of a warp meet in a bank.
// The next SHA block's loads are in flight while the current one is
// compressed (registers, then the other of two shared buffers). Padding
// is word arithmetic: the bytes at and past the hashed length are
// masked, 0x80 is OR-ed in, and the bit length goes into word 15 of the
// lane's last block. Everything after the hash indexes registers by
// compile-time constants only.
#include "fe25519.cuh"

constexpr int THREADS = 64;                // threads (lanes) a block
constexpr int COL = 33;                    // words a lane's column: 32 + 1 against bank conflicts
constexpr int BUF_WORDS = THREADS * COL;   // one SHA block of all the block's lanes
constexpr int SMEM_BYTES = 2 * BUF_WORDS * 4;
static_assert(THREADS % 32 == 0, "a tile is loaded by whole warps");

__constant__ uint64_t SHA_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ void sha512_compress(uint64_t H[8], uint64_t W[16]) {
    uint64_t a = H[0], b = H[1], c = H[2], d = H[3];
    uint64_t e = H[4], f = H[5], g = H[6], h = H[7];
#pragma unroll
    for (int t = 0; t < 80; ++t) {
        uint64_t w;
        if (t < 16) {
            w = W[t];
        } else {
            const uint64_t w15 = W[(t - 15) & 15], w2 = W[(t - 2) & 15];
            const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
            const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
            w = W[t & 15] + s0 + W[(t - 7) & 15] + s1;
            W[t & 15] = w;
        }
        const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        const uint64_t ch = (e & f) ^ (~e & g);
        const uint64_t t1 = h + S1 + ch + SHA_K[t] + w;
        const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + S0 + maj;
    }
    H[0] += a; H[1] += b; H[2] += c; H[3] += d;
    H[4] += e; H[5] += f; H[6] += g; H[7] += h;
}

// --- the hashed stream R || A || M, staged through shared memory --------

// Rows m0..m0+3 of a byte-major array with `rows` rows (0 past them),
// lanes l0..l0+3 of each in one word, lane l0 in the low byte. WORDS:
// one 4-byte load a row (all four lanes exist and every row is 4-byte
// aligned there); else four byte loads, lanes past n repeating lane
// n-1, from a row clamped into the array, so that no load sits behind
// a branch and all of them can be in flight before the first is used.
template <bool WORDS>
__device__ __forceinline__ void load_quad(uint32_t x[4], const uint8_t* base, size_t ld,
                                          int m0, int rows, int l0, int n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + i;
        if (WORDS) {
            x[i] = m < rows ? *reinterpret_cast<const uint32_t*>(base + (size_t)m * ld + l0) : 0;
        } else {
            const uint8_t* row = base + (size_t)min(m, rows - 1) * ld;
            uint32_t v = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) v |= (uint32_t)row[min(l0 + j, n - 1)] << (8 * j);
            x[i] = m < rows ? v : 0;
        }
    }
}

// Thread tid's share of a tile: lane quad q (the block's lanes 4q..4q+3)
// and row quads g, g+4, ..., g+28. A warp takes 8 lane quads x 4 row
// quads: a load reads 4 rows of 32 lanes, and the 32 stores of one word
// (row quad, lane j of the quad) fall in bank 4q + g + const, 32 banks.
__device__ __forceinline__ int tile_quad(int tid) { return tid % 8 + 8 * (tid / 32); }
__device__ __forceinline__ int tile_group(int tid) { return tid / 8 % 4; }

// Whether rows of `base`, `ld` apart, take word loads at lanes l0..l0+3
__device__ __forceinline__ bool word_rows(const uint8_t* base, size_t ld, int l0, int n) {
    return l0 + 3 < n && (((uintptr_t)(base + l0) | ld) & 3) == 0;
}

// This thread's share of SHA block `blk` of the stream R || A || M for
// the block's lanes, as tile_quad and tile_group share it out; x[4k+i]
// holds row 4(g+4k)+i.
// Block 0 is R (rows 0-31), A (32-63) and message rows 0-63; block
// blk > 0 is message rows 128 blk - 64 on. Rows past the bucket are 0.
template <bool WORDS>
__device__ __forceinline__ void load_msg_tile(uint32_t x[32], int blk, int tid, int lane0,
                                              const uint8_t* msgs, int cap, int n) {
    const int q = tile_quad(tid), g = tile_group(tid);
#pragma unroll
    for (int k = 0; k < 8; ++k)
        if (blk || k >= 4)
            load_quad<WORDS>(x + 4 * k, msgs, n, 128 * blk - 64 + 4 * (g + 4 * k), cap,
                             lane0 + 4 * q, n);
}

__device__ __forceinline__ void load_tile(uint32_t x[32], int blk, int tid, int lane0,
                                          const uint8_t* rs, const uint8_t* pks, int ld_pr,
                                          const uint8_t* msgs, int cap, int n) {
    const int l0 = lane0 + 4 * tile_quad(tid), g = tile_group(tid);
    if (blk == 0) {
        if (word_rows(rs, ld_pr, l0, n) && word_rows(pks, ld_pr, l0, n)) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                load_quad<true>(x + 4 * k, k < 2 ? rs : pks, ld_pr, 4 * (g + 4 * (k & 1)), 32,
                                l0, n);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                load_quad<false>(x + 4 * k, k < 2 ? rs : pks, ld_pr, 4 * (g + 4 * (k & 1)), 32,
                                 l0, n);
        }
    }
    if (cap == 0) {  // no message rows (only block 0 is loaded then)
#pragma unroll
        for (int k = 16; k < 32; ++k) x[k] = 0;
        return;
    }
    if (word_rows(msgs, n, l0, n)) load_msg_tile<true>(x, blk, tid, lane0, msgs, cap, n);
    else load_msg_tile<false>(x, blk, tid, lane0, msgs, cap, n);
}

// Transpose each 4 rows x 4 lanes of x into four big-endian words, one
// per lane: word r of a lane's column holds rows 4r..4r+3, row 4r in
// the top byte.
__device__ __forceinline__ void store_tile(uint32_t* buf, const uint32_t x[32], int tid) {
    const int q = tile_quad(tid), g = tile_group(tid);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint32_t* r = x + 4 * k;
        const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);  // lanes 0, 1 of rows 0, 1
        const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);  // lanes 2, 3
        const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
        uint32_t* col = buf + (4 * q) * COL + g + 4 * k;
        col[0 * COL] = __byte_perm(lo01, lo23, 0x0145);
        col[1 * COL] = __byte_perm(lo01, lo23, 0x2367);
        col[2 * COL] = __byte_perm(hi01, hi23, 0x0145);
        col[3 * COL] = __byte_perm(hi01, hi23, 0x2367);
    }
}

// --- scalars mod L, 21-bit limbs (ops/sc25519.py) ----------------------

__device__ __forceinline__ void sc_fold(int64_t s[24], int k) {
    s[k - 12] += s[k] * 666643;
    s[k - 11] += s[k] * 470296;
    s[k - 10] += s[k] * 654183;
    s[k - 9] -= s[k] * 997805;
    s[k - 8] += s[k] * 136657;
    s[k - 7] -= s[k] * 683901;
    s[k] = 0;
}

__device__ __forceinline__ void sc_carry_round(int64_t s[24], int i) {
    const int64_t c = (s[i] + (1LL << 20)) >> 21;
    s[i + 1] += c;
    s[i] -= c * (1LL << 21);
}

__device__ __forceinline__ void sc_carry_floor(int64_t* s, int i) {
    const int64_t c = s[i] >> 21;
    s[i + 1] += c;
    s[i] -= c * (1LL << 21);
}

__device__ __forceinline__ void sc_reduce(int64_t s[24]) {
#pragma unroll
    for (int k = 23; k >= 18; --k) sc_fold(s, k);
#pragma unroll
    for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
#pragma unroll
    for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
#pragma unroll
    for (int k = 17; k >= 12; --k) sc_fold(s, k);
#pragma unroll
    for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
#pragma unroll
    for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
    sc_fold(s, 12);
#pragma unroll
    for (int i = 0; i < 12; ++i) sc_carry_floor(s, i);
    sc_fold(s, 12);
#pragma unroll
    for (int i = 0; i < 12; ++i) sc_carry_floor(s, i);
}

// L in 13 limbs of 21 bits, and in four little-endian 64-bit words
// (called with constant indices only, so the arrays fold away)
__device__ __forceinline__ int64_t L_limb(int i) {
    const int64_t Ls[13] = {1430509, 1626855, 1442968, 997804, 1960495, 683900,
                            0, 0, 0, 0, 0, 0, 1};
    return Ls[i];
}
__device__ __forceinline__ uint64_t L_word(int i) {
    const uint64_t Lw[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                            0x0000000000000000ULL, 0x1000000000000000ULL};
    return Lw[i];
}

// bits [21i, 21i + 21) of the little-endian words d (all bits from 21i
// up where `rest`)
__device__ __forceinline__ int64_t limb_of(const uint64_t* d, int nwords, int i, bool rest) {
    const int off = 21 * i, w = off / 64, sh = off % 64;
    uint64_t v = d[w] >> sh;
    if (sh > 43 && w + 1 < nwords) v |= d[w + 1] << (64 - sh);
    return (int64_t)(rest ? v : v & ((1ULL << 21) - 1));
}

// window j = bits 4j..4j+3 of canonical 13-limb s
__device__ __forceinline__ uint8_t digit4(const int64_t s[13], int j) {
    const int limb = (4 * j) / 21, off = (4 * j) % 21;
    int64_t v = s[limb] >> off;
    if (off > 17) v |= s[limb + 1] << (21 - off);
    return (uint8_t)(v & 15);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__global__ void __launch_bounds__(THREADS)
hash_digits_kernel(const uint8_t* __restrict__ msgs, int cap, const int32_t* __restrict__ lens,
                   const uint8_t* __restrict__ pks, const uint8_t* __restrict__ rs, int ld_pr,
                   const uint8_t* __restrict__ ss, int n, uint8_t* __restrict__ ds,
                   uint8_t* __restrict__ dh, uint8_t* __restrict__ ok_s) {
    extern __shared__ int4 smem4[];
    uint32_t* const bufs = reinterpret_cast<uint32_t*>(smem4);
    const int tid = threadIdx.x, lane0 = blockIdx.x * THREADS;
    // a lane past n repeats lane n-1, joins every barrier, stores nothing
    const bool active = lane0 + tid < n;
    const int lane = active ? lane0 + tid : n - 1;

    // the first SHA block's loads go out before anything else
    uint32_t x[32];
    load_tile(x, 0, tid, lane0, rs, pks, ld_pr, msgs, cap, n);

    // s: its digits are its nibbles; s < L compares 64-bit words
    uint64_t sw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        uint64_t v = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) v |= (uint64_t)ss[(size_t)(8 * w + k) * n + lane] << (8 * k);
        sw[w] = v;
    }
    const int len = lens[lane] < cap ? lens[lane] : cap;  // never past the buffer
    const int total = 64 + len;                 // hashed bytes: R || A || M
    const int nblk = (total + 16) / 128 + 1;    // last block holds the length
    if (active) {
#pragma unroll
        for (int j = 0; j < 64; ++j)
            ds[(size_t)j * n + lane] = (uint8_t)((sw[j / 16] >> (4 * (j % 16))) & 15);
        bool lt = false, eq = true;
#pragma unroll
        for (int w = 3; w >= 0; --w) {
            lt = lt || (eq && sw[w] < L_word(w));
            eq = eq && sw[w] == L_word(w);
        }
        ok_s[lane] = lt ? 1 : 0;
    }

    store_tile(bufs, x, tid);
    uint64_t H[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
                     0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                     0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    // SHA block blk sits in buffer blk & 1; the barrier makes it visible
    // and frees the other buffer, read in the step before
#pragma unroll 1
    for (int blk = 0; __syncthreads_or(blk < nblk); ++blk) {
        const uint32_t* cur = bufs + (blk & 1) * BUF_WORDS;
        const bool more = 128 * (blk + 1) < 64 + cap;  // the next block has stream rows
        if (more) load_tile(x, blk + 1, tid, lane0, rs, pks, ld_pr, msgs, cap, n);
        uint64_t W[16];
        const uint32_t* col = cur + tid * COL;
#pragma unroll
        for (int w = 0; w < 16; ++w) {
            const uint64_t v = ((uint64_t)col[2 * w] << 32) | col[2 * w + 1];
            // bytes of this word left before the end of the hashed stream
            const int k = total - (128 * blk + 8 * w);
            const int kc = k < 0 ? 0 : k > 8 ? 8 : k;
            const uint64_t keep = kc ? ~0ULL << (64 - 8 * kc) : 0;
            const uint64_t pad = k >= 0 && k < 8 ? 0x80ULL << (56 - 8 * kc) : 0;
            W[w] = (v & keep) | pad;
        }
        if (blk == nblk - 1) W[15] |= (uint64_t)total * 8;
        if (blk < nblk) sha512_compress(H, W);
        if (more) store_tile(bufs + ((blk + 1) & 1) * BUF_WORDS, x, tid);
    }

    // digest bytes (big-endian words) as a little-endian 512-bit integer
    uint64_t d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
        d[i] = ((uint64_t)bswap32((uint32_t)H[i]) << 32) | bswap32((uint32_t)(H[i] >> 32));
    int64_t s[24];
#pragma unroll
    for (int i = 0; i < 24; ++i) s[i] = limb_of(d, 8, i, i == 23);
    sc_reduce(s);
    // hneg = L - h, floor carries
#pragma unroll
    for (int i = 0; i < 13; ++i) s[i] = L_limb(i) - s[i];
#pragma unroll
    for (int i = 0; i < 12; ++i) sc_carry_floor(s, i);
    if (active) {
#pragma unroll
        for (int j = 0; j < 64; ++j) dh[(size_t)j * n + lane] = digit4(s, j);
    }
}

// msgs (cap, n) uint8; lens (n,) int32; pks, rs (32, ld_pr) uint8 rows,
// lanes [0, n); ss (32, n); ds, dh (64, n) uint8; ok_s (n,) bytes
extern "C" int hash_digits_launch(const uint8_t* msgs, int cap, const int32_t* lens,
                                  const uint8_t* pks, const uint8_t* rs, int ld_pr,
                                  const uint8_t* ss, int n, uint8_t* ds, uint8_t* dh,
                                  uint8_t* ok_s, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    hash_digits_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        msgs, cap, lens, pks, rs, ld_pr, ss, n, ds, dh, ok_s);
    return (int)cudaGetLastError();
}

// launch facts, as kernel_info (fe25519.cuh) gives them
extern "C" int hash_digits_info(int* info) {
    return kernel_info(hash_digits_kernel, THREADS, SMEM_BYTES, info);
}
