// What one field operation of cometbft_tpu_torch/csrc/fe25519.cuh costs
// on the card: each thread runs a dependent chain of one operation and
// block 0's first thread reads clock64() around it.
// tools/torch_field_bench.py builds this file and launches it with one,
// four and eight warps per SM, which is one warp per scheduler at most
// or two: the latency of the chain, then the rate of the pipes when two
// warps share a scheduler.
//
// op 0 fe_mul, 1 fe_sq, 2 fe_add, 3 fe_sub, 4 the 100 products of a
// multiply without its carries, 5 the carries of a multiply (fe_carry3)
// without its products.
#include "fe25519.cuh"

template <int OP>
__global__ void field_chain(const int32_t* in, int32_t* out, long long* cycles, int iters) {
    Fe x, y;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        x.v[l] = in[l] + threadIdx.x;
        y.v[l] = in[NL + l];
    }
    const long long t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
        if (OP == 0) {
            x = fe_mul(x, y);
        } else if (OP == 1) {
            x = fe_sq(x);
        } else if (OP == 2) {
            x = fe_add(x, y);
        } else if (OP == 3) {
            x = fe_sub(x, y);
        } else {
            uint64_t t[NL];
#pragma unroll
            for (int k = 0; k < NL; ++k) t[k] = (uint64_t)(uint32_t)y.v[k] << 32;
            if (OP == 4) {
#pragma unroll
                for (int a = 0; a < NL; ++a)
#pragma unroll
                    for (int b = 0; b < NL; ++b)
                        t[(a + b) % NL] += (uint64_t)(uint32_t)x.v[a] * (uint32_t)y.v[b];
#pragma unroll
                for (int k = 0; k < NL; ++k) x.v[k] = (int32_t)(t[k] >> 7);
            } else {
#pragma unroll
                for (int k = 0; k < NL; ++k) t[k] += (uint32_t)x.v[k];
                x = fe_carry3(t);
            }
        }
    }
    const long long t1 = clock64();
    if (blockIdx.x == 0 && threadIdx.x == 0) *cycles = t1 - t0;
#pragma unroll
    for (int l = 0; l < NL; ++l) out[(blockIdx.x * blockDim.x + threadIdx.x) * NL + l] = x.v[l];
}

// in: 20 int32; out: blocks * threads * 10 int32; cycles: one int64
extern "C" int field_chain_launch(int op, int blocks, int threads, const int32_t* in,
                                  int32_t* out, long long* cycles, int iters) {
    switch (op) {
    case 0: field_chain<0><<<blocks, threads>>>(in, out, cycles, iters); break;
    case 1: field_chain<1><<<blocks, threads>>>(in, out, cycles, iters); break;
    case 2: field_chain<2><<<blocks, threads>>>(in, out, cycles, iters); break;
    case 3: field_chain<3><<<blocks, threads>>>(in, out, cycles, iters); break;
    case 4: field_chain<4><<<blocks, threads>>>(in, out, cycles, iters); break;
    case 5: field_chain<5><<<blocks, threads>>>(in, out, cycles, iters); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
