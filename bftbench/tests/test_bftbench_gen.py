"""The generators' signer and the card witness, on the CPU."""

import os

import torch

import tiny  # noqa: F401  (puts the checkout on the path)

from bftbench import witness
from bftbench.gen.keys import rng_for
from bftbench.gen.sign import Signer
from bftbench.reference import ed25519 as ref_ed


def test_signatures_verify_by_the_reference_and_a_flipped_bit_does_not():
    rng = rng_for(2**31 + 9, 0)
    seeds = [rng.bytes(32) for _ in range(5)]
    rows = [(s, os.urandom(120)) for s in seeds for _ in range(3)]
    sigs = Signer().sign(rows)
    pks = ref_ed.public_keys(seeds)
    assert all(ref_ed.verify(pks[i // 3], m, sig) for i, ((_, m), sig) in enumerate(zip(rows, sigs)))
    bad = bytearray(sigs[0])
    bad[40] ^= 1
    assert not ref_ed.verify(pks[0], rows[0][1], bytes(bad))
    assert Signer().sign(rows[:2]) == sigs[:2]  # the same seed, the same signatures


def test_witness_reads_no_false_lane_on_the_host_plane(monkeypatch):
    monkeypatch.setattr(witness, "POOL", 400)
    monkeypatch.setattr(witness, "WIDTHS", (10, 50))
    out = witness.witness(11, 1.0, 2, torch.device("cpu"), ref_workers=0)
    assert out["lanes"] > 0 and out["false_lanes"] == 0 and out["falses"] == []
