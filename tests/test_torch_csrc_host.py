"""The CUDA kernels' arithmetic, compiled for the host, vs the plain versions.

There is no nvcc on a CPU-only machine, but the kernels in
cometbft_tpu_torch/csrc/ are plain integer code. This test compiles each
source with the host C++ compiler, with the CUDA qualifiers defined
away and each ``<<<grid, block>>>`` launch rewritten to run the blocks
one after another and each block's threads at once, as ``std::thread``s
sharing the block's ``__shared__`` memory; ``__syncwarp`` and
``__syncthreads`` meet at one barrier of the block (K1's four threads
per lane wait on each other, so they cannot run as a loop). It calls
the same C entry points through ctypes on CPU tensors. Each kernel must
equal its plain PyTorch version exactly, at widths that leave quads,
warps and blocks partial; on the card, chip_smoke.py holds the real
build to the same versions.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch import kernels
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.ops import curve25519 as curve
from cometbft_tpu_torch.ops import ed25519 as ed
from cometbft_tpu_torch.ops import ladder
from cometbft_tpu_torch.ops import sc25519 as sc

# the plain versions run many small torch ops: one intra-op thread per
# test process, so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstring>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __constant__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef void* cudaStream_t;
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int x, int y) { return int2{x, y}; }
using std::min;
// byte k of the result is byte (s >> 4k) & 7 of the pair y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const unsigned long long xy = ((unsigned long long)y << 32) | x;
    unsigned r = 0;
    for (int k = 0; k < 4; ++k) r |= (unsigned)((xy >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
    return r;
}
struct host_dim3 { int x; };
static thread_local host_dim3 blockIdx, threadIdx, blockDim;
enum { cudaErrorInvalidValue = 1, cudaSharedmemCarveoutMaxShared = 100 };
enum cudaFuncAttribute {
    cudaFuncAttributeMaxDynamicSharedMemorySize,
    cudaFuncAttributePreferredSharedMemoryCarveout,
};
struct cudaFuncAttributes { int numRegs; size_t sharedSizeBytes, localSizeBytes; };
inline int cudaGetLastError() { return 0; }
template <class T> int cudaMemcpyToSymbol(T& sym, const void* src, size_t n) {
    std::memcpy(&sym, src, n);
    return 0;
}
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F> int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
    *a = {};
    return 0;
}
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, F, int, size_t) {
    *b = 0;
    return 0;
}
// one block at a time: its dynamic shared memory, and its barrier
alignas(16) int4 smem4[1 << 14];
static std::barrier<>* block_barrier;
inline void __syncwarp(unsigned = 0xffffffffu) { block_barrier->arrive_and_wait(); }
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// call k of a block ORs into or_acc[k % 3]; after the barrier, thread 0
// clears the word of call k + 2, whose last readers (call k - 1) are done
static std::atomic<int> or_acc[3];
static thread_local int or_calls;
inline int __syncthreads_or(int pred) {
    const int k = or_calls++ % 3;
    if (pred) or_acc[k] |= 1;
    block_barrier->arrive_and_wait();
    const int r = or_acc[k].load();
    if (threadIdx.x == 0) or_acc[(k + 2) % 3] = 0;
    return r;
}
template <class F> void host_launch(int blocks, int threads, F body) {
    for (int b = 0; b < blocks; ++b) {
        std::barrier<> bar(threads);
        block_barrier = &bar;
        for (auto& a : or_acc) a = 0;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
            ts.emplace_back([=] {
                blockIdx.x = b, threadIdx.x = t, blockDim.x = threads;
                body();
            });
        for (auto& th : ts) th.join();
    }
}
"""

P = ref.P


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' sources")
    out = tmp_path_factory.mktemp("csrc_host")
    (out / "cuda_runtime.h").write_text(STUB)
    procs = {}
    for name, src in kernels.SOURCES.items():
        code = (kernels.CSRC / src).read_text()
        code = re.sub(
            r"(\w+(?:<\w+>)?)<<<\s*([^,]+),\s*([^,]+),[^>]*>>>\(([^;]*)\);",
            r"host_launch(\2, \3, [&] { \1(\4); });", code,
        )
        (out / f"{name}.cpp").write_text(code)
        procs[name] = subprocess.Popen(
            [cxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC", "-I", str(out),
             "-I", str(kernels.CSRC), "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    loaded = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, argtypes in kernels.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
    assert ladder._init(loaded["ladder"]) == 0
    return loaded


def _cols(rows):
    return torch.tensor(np.stack([np.frombuffer(r, np.uint8) for r in rows], 1).copy())


EDGES = [
    ref.point_compress(ref.IDENTITY), (P - 1).to_bytes(32, "little"),
    (P + 1).to_bytes(32, "little"), (1 << 255).to_bytes(32, "little"),
    (2).to_bytes(32, "little"),
]


def _decompress(libs, b):
    n = b.shape[1]
    out = torch.zeros((4, 10, n), dtype=torch.int32)
    ok = torch.zeros(n, dtype=torch.bool)
    rc = libs["decompress"].decompress_launch(
        b.data_ptr(), n, n, out.data_ptr(), n, ok.data_ptr(), None
    )
    assert rc == 0
    return out, ok


def test_decompress_kernel_equals_plain(libs):
    rng = np.random.default_rng(8)
    encs = EDGES + [ref.public_from_seed(bytes([i]) * 32) for i in range(4)]
    encs += [rng.bytes(32) for _ in range(7)]
    b = _cols(encs)
    out, ok = _decompress(libs, b)
    want, want_ok = curve.decompress_plain(b)
    assert torch.equal(out, want) and torch.equal(ok, want_ok)


# lanes: partial quads, warps and blocks (K1 takes 32 lanes a block, K2 64)
RAGGED = [1, 3, 7, 33, 65]


@pytest.mark.parametrize("n", RAGGED)
def test_decompress_kernel_ragged_widths(libs, n):
    encs = EDGES + [ref.public_from_seed(bytes([i]) * 32) for i in range(n)]
    encs = (encs[::-1] if n % 2 else encs)[:n]
    b = _cols(encs)
    out, ok = _decompress(libs, b)
    want, want_ok = curve.decompress_plain(b)
    assert torch.equal(out, want) and torch.equal(ok, want_ok)


def _check_hash_digits(libs, n, cap, lens, seed, ld_pr=None):
    """K3 on n lanes of the bucket cap, with pks and rs as rows ld_pr
    apart (default 2n) of one buffer, exactly against the plain version."""
    rng = np.random.default_rng(seed)
    ld_pr = 2 * n if ld_pr is None else ld_pr
    lens = np.asarray(lens, np.int32)
    msgs = np.zeros((cap, n), np.uint8)
    for i, ln in enumerate(lens):
        msgs[: min(ln, cap), i] = rng.integers(0, 256, min(ln, cap), dtype=np.uint8)
    pr = torch.tensor(rng.integers(0, 256, (32, ld_pr), dtype=np.uint8))
    pks, rs = pr[:, :n], pr[:, ld_pr - n:]
    ss = rng.integers(0, 256, (32, n), dtype=np.uint8)
    for i, v in enumerate((sc.L - 1, sc.L, sc.L + 1, 0)[:n]):
        ss[:, i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    msgs, lens, ss = torch.tensor(msgs), torch.tensor(lens), torch.tensor(ss)
    ds = torch.zeros((64, n), dtype=torch.uint8)
    dh = torch.zeros((64, n), dtype=torch.uint8)
    ok_s = torch.zeros(n, dtype=torch.bool)
    rc = libs["hash_digits"].hash_digits_launch(
        msgs.data_ptr(), cap, lens.data_ptr(), pks.data_ptr(), rs.data_ptr(), ld_pr,
        ss.data_ptr(), n, ds.data_ptr(), dh.data_ptr(), ok_s.data_ptr(), None,
    )
    assert rc == 0
    want = sc.hash_digits_plain(msgs, lens, pks, rs, ss)
    assert all(torch.equal(g, w) for g, w in zip((ds, dh, ok_s), want))


def _mixed_lens(rng, n, cap):
    """Lengths that give one block lanes of every SHA block count the
    bucket allows, with the block-count edges (47/48, 111/112 bytes...)."""
    edges = [ln for b in range(8) for ln in (128 * b + 47, 128 * b + 48) if ln <= cap]
    lens = rng.integers(0, cap + 1, n)
    lens[: len(edges) + 2] = ([0, cap] + edges)[:n]
    return rng.permutation(lens)


def test_hash_digits_kernel_equals_plain(libs):
    lens = [0, 1, 47, 48, 111, 112, 175, 300, 431, 432, 900, 943]
    _check_hash_digits(libs, len(lens), ed.MSG_CAPS[-1], lens, 9)


def test_hash_digits_kernel_clamps_lengths_to_cap(libs):
    """A length above the bucket counts as the bucket, in kernel and
    plain version alike; the kernel reads nothing past the buffer."""
    rng = np.random.default_rng(11)
    cap, n = ed.MSG_CAPS[0], 3
    msgs = torch.tensor(rng.integers(0, 256, (cap, n), dtype=np.uint8))
    pr = torch.tensor(rng.integers(0, 256, (32, 2 * n), dtype=np.uint8))
    ss = torch.tensor(rng.integers(0, 256, (32, n), dtype=np.uint8))
    over = torch.tensor([cap + 1, 10 * cap, 2**30], dtype=torch.int32)
    got = [torch.zeros((64, n), dtype=torch.uint8) for _ in range(2)]
    ok_s = torch.zeros(n, dtype=torch.bool)
    rc = libs["hash_digits"].hash_digits_launch(
        msgs.data_ptr(), cap, over.data_ptr(), pr.data_ptr(), pr[:, n:].data_ptr(),
        2 * n, ss.data_ptr(), n, got[0].data_ptr(), got[1].data_ptr(),
        ok_s.data_ptr(), None,
    )
    assert rc == 0
    at_cap = torch.full((n,), cap, dtype=torch.int32)
    want = sc.hash_digits_plain(msgs, at_cap, pr[:, :n], pr[:, n:], ss)
    assert all(torch.equal(g, w) for g, w in zip((*got, ok_s), want))
    plain = sc.hash_digits(msgs, over, pr[:, :n], pr[:, n:], ss)
    assert all(torch.equal(g, w) for g, w in zip(plain, want))


# K3 takes 64 lanes a block: partial 4-lane groups, warps and blocks
@pytest.mark.parametrize("n", RAGGED + [129])
def test_hash_digits_kernel_ragged_widths(libs, n):
    rng = np.random.default_rng(200 + n)
    cap = ed.MSG_CAPS[2]
    _check_hash_digits(libs, n, cap, _mixed_lens(rng, n, cap), 300 + n)


@pytest.mark.parametrize("cap", ed.MSG_CAPS)
def test_hash_digits_kernel_every_bucket(libs, cap):
    """132 lanes: rows 4-byte aligned, so whole 4-lane groups take the
    word loads; 943 bytes is 8 SHA blocks, so both buffers turn over."""
    rng = np.random.default_rng(cap)
    _check_hash_digits(libs, 132, cap, _mixed_lens(rng, 132, cap), cap + 1)


@pytest.mark.parametrize("n", [150, 67])
def test_hash_digits_kernel_unaligned_rows(libs, n):
    """n % 4 != 0 and an odd row stride for pks and rs: loads fall back
    to single bytes wherever a 4-lane group is not 4-byte aligned."""
    rng = np.random.default_rng(400 + n)
    cap = ed.MSG_CAPS[1]
    _check_hash_digits(libs, n, cap, _mixed_lens(rng, n, cap), 500 + n, ld_pr=2 * n + 1)


def _ladder_inputs(n, seed):
    """n signed items (every third corrupted, one order-2 key with the
    identity R) through the plain stages, and random digits."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        k = Ed25519PrivKey.from_seed(rng.bytes(32))
        m = rng.bytes(20 * (i % 7))
        items.append((m, k.pub_key().key_bytes, k.sign(m)))
    for i in range(2, n, 3):
        m, pk, sig = items[i]
        items[i] = (m + b"x", pk, sig)
    if n > 1:
        ident = ref.point_compress(ref.IDENTITY)
        items[-1] = (b"msg", (P - 1).to_bytes(32, "little"), ident + bytes(32))
    msgs, lens, pr, ss, _, _ = ed.pack(items, False)
    msgs, pr, ss = (torch.tensor(a.T.copy()) for a in (msgs, pr, ss))
    lens = torch.tensor(lens)
    ds, dh, ok_s = sc.hash_digits_plain(msgs, lens, pr[:, :n], pr[:, n:], ss)
    pt, ok = curve.decompress_plain(pr)
    rds = torch.tensor(rng.integers(0, 16, (64, n), dtype=np.uint8))
    rdh = torch.tensor(rng.integers(0, 16, (64, n), dtype=np.uint8))
    return items, (ds, dh, ok_s), (pt, ok), (rds, rdh)


def _check_ladder(libs, n, seed):
    """Bare entry on random digits, fused entry on real signatures;
    returns the fused verdicts."""
    items, (ds, dh, ok_s), (pt, ok), (rds, rdh) = _ladder_inputs(n, seed)
    out = torch.zeros((3, 10, n), dtype=torch.int32)
    rc = libs["ladder"].straus_launch(
        rds.data_ptr(), rdh.data_ptr(), n, pt.data_ptr(), 2 * n,
        out.data_ptr(), None,
    )
    assert rc == 0
    assert torch.equal(out, ladder.straus_plain(rds, rdh, pt[..., :n]))

    verdict = torch.zeros(n, dtype=torch.bool)
    rc = libs["ladder"].verify_launch(
        ds.data_ptr(), dh.data_ptr(), n, pt.data_ptr(), 2 * n,
        pt[..., n:].data_ptr(), 2 * n, ok.data_ptr(), ok[n:].data_ptr(),
        ok_s.data_ptr(), verdict.data_ptr(), None,
    )
    assert rc == 0
    want = ladder.verify_plain(ds, dh, pt[..., :n], pt[..., n:], ok[:n], ok[n:], ok_s)
    assert torch.equal(verdict, want)
    assert verdict.tolist() == [ref.verify_zip215(pk, m, s) for m, pk, s in items]
    return verdict


def test_ladder_kernels_equal_plain(libs):
    """Bare entry on random digits, fused entry on real signatures."""
    verdict = _check_ladder(libs, 7, 10)
    assert verdict.tolist() == [True, True, False, True, True, False, True]


@pytest.mark.parametrize("n", RAGGED)
def test_ladder_kernels_ragged_widths(libs, n):
    _check_ladder(libs, n, 100 + n)
