// K3: per-lane SHA-512(R || A || M), h mod L, -h mod L, window digits.
//
// Replaces the JAX package's XLA stages cometbft_tpu/ops/sha512.py::
// sha512 and cometbft_tpu/ops/sc25519.py::reduce_512, neg_mod_L,
// digits4, lt_L (and hash_bytes_to_limbs). Plain version:
// cometbft_tpu_torch/ops/sc25519.py::hash_digits_plain.
//
// SHA-512 runs on native 64-bit words (the JAX package splits them
// into uint32 halves because the TPU has no int64). Each thread hashes
// its own lane for exactly as many blocks as the lane's length needs,
// reading the message byte by byte from the (cap, n) byte-major array,
// so neighbouring threads read neighbouring bytes. The reduction mod L
// is ref10's sc_reduce schedule on 21-bit limbs in int64.
//
// Bound: 64-bit logic and adds of the compression function (~80 rounds
// x ~40 word operations per 128-byte block, each 64-bit operation two
// 32-bit instructions) — 1 to 8 blocks per lane — plus the message
// bytes read once. Everything stays in registers.
#include "fe25519.cuh"

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

__device__ void sha512_compress(uint64_t H[8], uint64_t W[16]) {
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

__device__ void sc_reduce(int64_t s[24]) {
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

// L in 13 limbs of 21 bits
__device__ __forceinline__ int64_t L_limb(int i) {
    const int64_t Ls[13] = {1430509, 1626855, 1442968, 997804, 1960495, 683900,
                            0, 0, 0, 0, 0, 0, 1};
    return Ls[i];
}

// window j = bits 4j..4j+3 of canonical 13-limb s
__device__ __forceinline__ uint8_t digit4(const int64_t s[13], int j) {
    const int limb = (4 * j) / 21, off = (4 * j) % 21;
    int64_t v = s[limb] >> off;
    if (off > 17) v |= s[limb + 1] << (21 - off);
    return (uint8_t)(v & 15);
}

__global__ void __launch_bounds__(128)
hash_digits_kernel(const uint8_t* __restrict__ msgs, int cap, const int32_t* __restrict__ lens,
                   const uint8_t* __restrict__ pks, const uint8_t* __restrict__ rs, int ld_pr,
                   const uint8_t* __restrict__ ss, int n, uint8_t* __restrict__ ds,
                   uint8_t* __restrict__ dh, uint8_t* __restrict__ ok_s) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const int len = lens[lane] < cap ? lens[lane] : cap;  // never past the buffer
    const int total = 64 + len;                 // hashed bytes: R || A || M
    const int nblk = (total + 16) / 128 + 1;    // last block holds the length
    const uint32_t bitlen = (uint32_t)total * 8;
    uint64_t H[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
                     0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                     0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    for (int blk = 0; blk < nblk; ++blk) {
        uint64_t W[16];
#pragma unroll
        for (int w = 0; w < 16; ++w) {
            uint64_t word = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int p = blk * 128 + w * 8 + k;
                uint32_t byte;
                if (p < 32) byte = rs[(size_t)p * ld_pr + lane];
                else if (p < 64) byte = pks[(size_t)(p - 32) * ld_pr + lane];
                else if (p < total) byte = msgs[(size_t)(p - 64) * n + lane];
                else if (p == total) byte = 0x80;
                else if (blk == nblk - 1 && w * 8 + k >= 124)
                    byte = (bitlen >> (8 * (127 - (w * 8 + k)))) & 0xFF;
                else byte = 0;
                word = (word << 8) | byte;
            }
            W[w] = word;
        }
        sha512_compress(H, W);
    }
    // digest bytes (big-endian words) as a little-endian 512-bit integer
    uint8_t dig[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) dig[q] = (uint8_t)(H[q >> 3] >> (56 - 8 * (q & 7)));
    int64_t s[24];
#pragma unroll
    for (int i = 0; i < 24; ++i) s[i] = pack_limb(dig, 64, 21 * i, 21, i == 23);
    sc_reduce(s);
    // hneg = L - h, floor carries
#pragma unroll
    for (int i = 0; i < 13; ++i) s[i] = L_limb(i) - s[i];
#pragma unroll
    for (int i = 0; i < 12; ++i) sc_carry_floor(s, i);
    // s scalar from the signature
    uint8_t sb[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) sb[k] = ss[(size_t)k * n + lane];
    int64_t sc[13];
#pragma unroll
    for (int i = 0; i < 13; ++i) sc[i] = pack_limb(sb, 32, 21 * i, 21, i == 12);
#pragma unroll
    for (int j = 0; j < 64; ++j) {
        ds[(size_t)j * n + lane] = digit4(sc, j);
        dh[(size_t)j * n + lane] = digit4(s, j);
    }
    // s < L, lexicographic from the top limb
    bool lt = false, eq = true;
#pragma unroll
    for (int i = 12; i >= 0; --i) {
        lt = lt || (eq && sc[i] < L_limb(i));
        eq = eq && (sc[i] == L_limb(i));
    }
    ok_s[lane] = lt ? 1 : 0;
}

// msgs (cap, n) uint8; lens (n,) int32; pks, rs (32, ld_pr) uint8 rows,
// lanes [0, n); ss (32, n); ds, dh (64, n) uint8; ok_s (n,) bytes
extern "C" int hash_digits_launch(const uint8_t* msgs, int cap, const int32_t* lens,
                                  const uint8_t* pks, const uint8_t* rs, int ld_pr,
                                  const uint8_t* ss, int n, uint8_t* ds, uint8_t* dh,
                                  uint8_t* ok_s, void* stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    hash_digits_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        msgs, cap, lens, pks, rs, ld_pr, ss, n, ds, dh, ok_s);
    return (int)cudaGetLastError();
}
