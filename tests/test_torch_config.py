"""The port's config against the JAX package's: the sections this slice
brings (``[fuzz]``, ``[crypto]``, ``[fleet]`` and ``[instrumentation]
sanitizer``) and what ``build_node`` does with them.

- A ``config.toml`` the JAX package writes, with every section and
  non-default values in the three new ones, loads whole in the port,
  and every field the port has equals the JAX loader's value; the
  port's writer gives a file the JAX loader reads to the same values.
- ``[crypto] batch_backend``: "tpu" (the JAX name of the device route)
  becomes the process-wide "cuda" backend, "cpu" and "cpu-parallel"
  are applied as named, "" inherits, and "mesh" (ported with ROADMAP
  A5) is applied too: its verifier takes the host plane with fewer than
  two CUDA devices.
- ``[instrumentation] sanitizer``: on, ``build_node`` enables the
  runtime sanitizer before the planes build their locks (the block
  store's lock is then a ``SanitizedLock``); off, and with the
  sanitizer disabled, the locks are the raw ones.
"""

import threading
from dataclasses import fields

import pytest

from cometbft_tpu.config import config as jconfig
from cometbft_tpu_torch.analysis import runtime
from cometbft_tpu_torch.config import config as pconfig
from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
from torch_hard_limit import hard_limit  # noqa: F401

SECTIONS = ("base", "rpc", "p2p", "mempool", "statesync", "blocksync", "consensus", "storage", "tx_index",
            "instrumentation", "fuzz", "crypto", "fleet")


@pytest.fixture
def default_backend():
    old = batch.default_backend()
    yield
    batch.set_default_backend(old)


@pytest.fixture
def sanitizer_state():
    san = runtime.get_sanitizer()
    was = san.enabled
    yield san
    san.enable() if was else san.disable()


def test_a_jax_written_config_loads_whole(tmp_path):
    home = tmp_path / "home"
    cfg = jconfig.default_config(str(home))
    cfg.fuzz.enable = True
    cfg.fuzz.mode = "delay"
    cfg.fuzz.prob_sleep = 0.05
    cfg.fuzz.max_delay_ms = 50
    cfg.fuzz.seed = 11
    cfg.crypto.batch_backend = "tpu"
    cfg.crypto.max_lanes = 4096
    cfg.fleet.max_sessions = 30_000
    cfg.fleet.max_lag_heights = 3
    cfg.fleet.token_wait_s = 10.0
    cfg.instrumentation.sanitizer = True
    cfg.consensus.timeout_commit_s = 0.3
    path = home / "config" / "config.toml"
    jconfig.write_toml(cfg, str(path))
    ours, theirs = pconfig.load_toml(str(path)), jconfig.load_toml(str(path))
    for section in SECTIONS:
        a, b = getattr(ours, section), getattr(theirs, section)
        for f in fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), (section, f.name)
    assert ours.fuzz.seed == 11 and ours.fleet.max_sessions == 30_000 and ours.crypto.batch_backend == "tpu"
    # and back: the port's writer gives a file the JAX loader reads alike
    back = tmp_path / "back" / "config" / "config.toml"
    pconfig.write_toml(ours, str(back))
    reread = pconfig.load_toml(str(back))
    assert reread.root_dir == str(tmp_path / "back")
    reread.root_dir = ours.root_dir
    assert reread == ours
    again = jconfig.load_toml(str(back))
    for section in SECTIONS:
        a = getattr(ours, section)
        for f in fields(a):
            assert getattr(a, f.name) == getattr(getattr(again, section), f.name), (section, f.name)


def test_a_key_the_port_does_not_read_loads_only_at_its_jax_default(tmp_path):
    path = tmp_path / "config" / "config.toml"
    path.parent.mkdir()
    for (section, key), value in pconfig.JAX_UNREAD.items():
        assert getattr(getattr(jconfig.default_config("."), section), key) == value
        path.write_text(f"[{section}]\n{key} = {value!r}\n".replace("'", '"').replace("False", "false"))
        pconfig.load_toml(str(path))
    path.write_text('[p2p]\nmax_num_inbound_peers = 12\n')
    with pytest.raises(ValueError, match="max_num_inbound_peers"):
        pconfig.load_toml(str(path))


@pytest.mark.parametrize("value, backend", [("tpu", "cuda"), ("cuda", "cuda"), ("cpu", "cpu"),
                                            ("cpu-parallel", "cpu-parallel"), ("", None),
                                            ("mesh", "mesh")])
def test_batch_backend_applies_at_build(default_backend, value, backend):
    gen, _ = make_genesis(1, chain_id="crypto-cfg")
    cfg = pconfig.test_config(".")
    cfg.crypto.batch_backend = value
    batch.set_default_backend("cpu-parallel" if backend is None else "cpu")
    before = batch.default_backend()
    parts = build_node(gen, config=cfg, device="cpu")
    parts.close_stores()
    assert batch.default_backend() == (before if backend is None else backend)
    assert batch.config_backend(value or "cuda") == (backend or "cuda")


def test_batch_backend_mesh_raises_naming_a5(default_backend):
    """Since ROADMAP A5 was ported, "mesh" no longer raises: it builds.
    ``build_node`` makes it the process-wide backend, whose verifier
    sends the lanes to the cards and, with no card (none here),
    verifies on the host plane with the serial verdicts, as the JAX
    backend does without a mesh. (The name is kept from when the value
    raised, naming A5.)"""
    from cometbft_tpu_torch.crypto import mesh_backend
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    gen, _ = make_genesis(1, chain_id="crypto-mesh")
    cfg = pconfig.test_config(".")
    cfg.crypto.batch_backend = "mesh"
    parts = build_node(gen, config=cfg, device="cpu")
    parts.close_stores()
    assert batch.config_backend("mesh") == "mesh"
    assert batch.default_backend() == "mesh"
    v = batch.create_batch_verifier(device="cpu")
    assert isinstance(v, mesh_backend.MeshBatchVerifier)
    sk = Ed25519PrivKey.from_seed(b"\x07" * 32)
    v.add(sk.pub_key(), b"m", sk.sign(b"m"))
    v.add(sk.pub_key(), b"n", sk.sign(b"m"))
    assert v.verify() == (False, [True, False])


def test_sanitizer_setting_enables_before_the_planes_build(sanitizer_state):
    san = sanitizer_state
    gen, _ = make_genesis(1, chain_id="san-cfg")
    san.disable()
    cfg = pconfig.default_config(".")
    cfg.base.db_backend = "memdb"
    assert cfg.instrumentation.sanitizer is False
    assert pconfig.test_config(".").instrumentation.sanitizer is True
    parts = build_node(gen, config=cfg, device="cpu")
    assert not san.enabled
    assert type(parts.block_store._lock) is type(threading.RLock())
    parts.close_stores()
    cfg.instrumentation.sanitizer = True
    parts = build_node(gen, config=cfg, device="cpu")
    assert san.enabled
    assert isinstance(parts.block_store._lock, runtime.SanitizedLock)
    assert parts.block_store._lock.name == "store.block"
    parts.close_stores()
