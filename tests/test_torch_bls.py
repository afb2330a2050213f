"""The port's BLS12-381 keys behind the JAX package's gate: the two cases
of ``tests/test_aux_tools.py`` (off by default; sign and verify, with
the registry's dispatch, when ``COMETBFT_TPU_BLS12381`` is set), and
the same seed giving the same public key and signature in both
packages, each verifying the other's."""

import pytest

from cometbft_tpu.crypto import keys as jkeys


def test_bls_gated_off_by_default(monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_BLS12381", raising=False)
    from cometbft_tpu_torch.crypto.keys import Bls12381PubKey, pubkey_from_type_bytes

    with pytest.raises(NotImplementedError):
        Bls12381PubKey(b"\x00" * 48)
    with pytest.raises(NotImplementedError):
        pubkey_from_type_bytes("bls12381", b"\x00" * 48)


def test_bls_sign_verify_when_enabled(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_BLS12381", "1")
    from cometbft_tpu_torch.crypto import encoding
    from cometbft_tpu_torch.crypto.keys import Bls12381PrivKey, pubkey_from_type_bytes

    priv = Bls12381PrivKey.from_seed(b"test-seed")
    pub = priv.pub_key()
    sig = priv.sign(b"vote-sign-bytes")
    assert pub.verify(b"vote-sign-bytes", sig)
    assert not pub.verify(b"other-bytes", sig)
    pk2 = pubkey_from_type_bytes("bls12381", bytes(pub))
    assert pk2.verify(b"vote-sign-bytes", sig)
    assert encoding.pubkey_from_type_and_bytes("bls12381", bytes(pub)) == pk2
    with pytest.raises(encoding.ErrInvalidKeyLen):
        encoding.pubkey_from_type_and_bytes("bls12381", bytes(pub)[:47])

    # the JAX package: same key and signature from the same seed
    jpriv = jkeys.Bls12381PrivKey.from_seed(b"test-seed")
    assert bytes(jpriv.pub_key()) == bytes(pub)
    assert jpriv.sign(b"vote-sign-bytes") == sig
    assert jkeys.pubkey_from_type_bytes("bls12381", bytes(pub)).verify(b"vote-sign-bytes", sig)
