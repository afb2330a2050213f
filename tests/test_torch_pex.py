"""The port's PEX reactor and address book (cometbft_tpu_torch.p2p.pex)
against the JAX package's, on the CPU.

- The seven cases of the JAX package's tests/test_pex.py, on the port:
  the book's basics, its persisted bookkeeping and the forgiveness of
  aged attempt counters, a re-learned address replacing a failing one,
  the old-then-new selection, the dial gate on attempts, and three
  Nodes where PEX connects A to C, which A learns of only through B.
- Bytes: books filled from one numpy seed save to the same JSON from
  both packages, and each package loads the other's file to the same
  entries; the reactors send the same request and, with the random
  shuffle seeded alike, the same response, and each reactor learns the
  addresses of the other package's response.
"""

import asyncio
import json
import random

import numpy as np
import pytest

from cometbft_tpu.p2p import pex as jpex
from cometbft_tpu_torch.p2p import pex as ppex
from cometbft_tpu_torch.p2p.pex import AddrBook
from torch_hard_limit import hard_limit  # noqa: F401

SEED = 0x0E


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_addrbook_basics(tmp_path):
    book = AddrBook(str(tmp_path / "addrbook.json"), our_id="me")
    assert book.add_address("aa@1.2.3.4:1")
    assert not book.add_address("aa@1.2.3.4:1")  # dup
    assert not book.add_address("me@5.6.7.8:1")  # self
    book.mark_good("aa", "aa@1.2.3.4:1")
    book.add_address("bb@2.3.4.5:2", src="aa")
    sel = book.selection()
    assert "aa@1.2.3.4:1" in sel and "bb@2.3.4.5:2" in sel
    book.save()
    book2 = AddrBook(str(tmp_path / "addrbook.json"), our_id="me")
    assert book2.size() == 2
    assert book2.addrs["aa"].is_old


def test_addrbook_bookkeeping_persists(tmp_path):
    """Dial success/failure history survives a restart: the reconnect
    plane and pick_to_dial's backoff gating key on attempts /
    last_attempt / failures."""
    path = str(tmp_path / "addrbook.json")
    book = AddrBook(path, our_id="me")
    book.add_address("aa@1.2.3.4:1")
    book.mark_attempt("aa")
    book.mark_attempt("aa")
    book.mark_failed("aa")
    # mark_failed with addr creates the entry (persistent peer never
    # PEX-learned still accumulates health history)
    book.mark_failed("cc", "cc@9.9.9.9:3")
    book.save()
    again = AddrBook(path, our_id="me")
    aa = again.addrs["aa"]
    assert aa.attempts == 2
    assert aa.last_attempt > 0
    assert aa.failures == 1
    assert aa.last_failure > 0
    assert again.addrs["cc"].failures == 1
    # a success resets the attempt counter (the bad-address gate) but
    # keeps the flap history
    again.mark_good("aa", "aa@1.2.3.4:1")
    assert again.addrs["aa"].attempts == 0
    assert again.addrs["aa"].failures == 1


def test_addrbook_persisted_attempts_age_out(tmp_path):
    """Forgiveness: a never-connected address that crossed the
    bad-address attempt cap does not stay is_bad forever across
    restarts — stale attempt counters reload clean (failure history
    stays), while fresh ones persist."""
    import time as _time

    from cometbft_tpu_torch.p2p.pex import FORGIVE_AFTER_S

    path = str(tmp_path / "addrbook.json")
    book = AddrBook(path, our_id="me")
    book.add_address("aa@h:1")
    book.addrs["aa"].attempts = 99  # crossed MAX_ATTEMPTS, no success
    book.addrs["aa"].failures = 99
    book.addrs["aa"].last_attempt = _time.time() - FORGIVE_AFTER_S - 60
    book.add_address("bb@h:2")
    book.mark_attempt("bb")  # fresh: must survive the reload
    book.save()
    again = AddrBook(path, our_id="me")
    assert again.addrs["aa"].attempts == 0  # forgiven
    assert not again.addrs["aa"].is_bad
    assert again.addrs["aa"].failures == 99  # history kept
    assert again.addrs["bb"].attempts == 1  # fresh: persisted
    # a re-learned NEW address also resets the counter live
    book.addrs["bb"].attempts = 99
    book.add_address("bb@moved:9")
    assert book.addrs["bb"].attempts == 0
    assert book.addrs["bb"].addr == "bb@moved:9"


def test_addrbook_relearned_address_replaces_failing_old_entry():
    """A moved peer is not shadowed by its stale proven entry: while
    the known address keeps failing, re-learned routing info replaces
    it; while it is healthy, it is sticky; and a live connection at a
    new address always wins."""
    book = AddrBook(our_id="me")
    book.add_address("aa@old:1")
    book.mark_good("aa")  # proven -> is_old, addr sticky
    book.add_address("aa@moved:2", src="pex")
    assert book.addrs["aa"].addr == "aa@old:1"  # healthy: sticky
    book.mark_failed("aa")  # conn died / dials failing
    book.add_address("aa@moved:2", src="pex")
    assert book.addrs["aa"].addr == "aa@moved:2"  # failing: re-learn
    book.mark_good("aa", "aa@live:3")
    assert book.addrs["aa"].addr == "aa@live:3"
    assert book.addrs["aa"].is_old


def test_addrbook_selection_biases_old_then_new():
    """selection(): old (proven) addresses lead, new fill the tail,
    bad addresses are excluded (reference GetSelection bias)."""
    book = AddrBook(our_id="me")
    for i in range(6):
        book.add_address(f"new{i}@h:{i}")
    for i in range(3):
        book.add_address(f"old{i}@H:{i}")
        book.mark_good(f"old{i}")
    bad = book.addrs["new0"]
    bad.attempts = 100  # is_bad: many attempts, never a success
    sel = book.selection(limit=6)
    assert "new0@h:0" not in sel
    head = sel[:3]
    assert {a.partition("@")[0] for a in head} == {"old0", "old1", "old2"}, sel
    assert len(sel) == 6
    for _ in range(10):
        s = book.selection(limit=6)
        assert all(a.startswith("old") for a in s[:3])


def test_addrbook_pick_to_dial_gates_on_attempt_backoff():
    """pick_to_dial: excludes live/banned ids, bad addresses, and
    addresses attempted too recently (10s * (attempts+1) gate)."""
    import time as _time

    book = AddrBook(our_id="me")
    book.add_address("aa@h:1")
    book.add_address("bb@h:2")
    book.add_address("cc@h:3")
    book.mark_attempt("aa")  # attempted just now -> gated out
    book.mark_attempt("bb")
    book.addrs["bb"].last_attempt = _time.time() - 120.0  # long ago
    picks = book.pick_to_dial(exclude={"cc"}, n=10)
    assert picks == ["bb@h:2"]
    # the gate scales with attempt count: 2 attempts => 30s window
    book.addrs["bb"].attempts = 2
    book.addrs["bb"].last_attempt = _time.time() - 25.0
    assert "bb@h:2" not in book.pick_to_dial(exclude=set(), n=10)


def test_pex_discovers_indirect_peer():
    """A knows only B; B knows C. PEX must connect A to C."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.crypto import parallel_verify as pv
    from cometbft_tpu_torch.crypto import scheduler as sched_mod
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node

    gen, privs = make_genesis(3, chain_id="pex-chain")
    pvs = make_privvals(privs)

    async def main():
        nodes = []
        for i, pv_ in enumerate(pvs):
            cfg = make_test_cfg(".")
            cfg.base.moniker = f"node{i}"
            cfg.blocksync.enable = False
            cfg.p2p.pex = True
            nodes.append(Node(cfg, gen, privval=pv_, device="cpu"))
        for n in nodes:
            await n.start()
        try:
            a, b, c = nodes
            await b.dial(c.listen_addr)  # B <-> C
            await asyncio.sleep(0.2)
            await a.dial(b.listen_addr)  # A -> B (outbound: requests addrs)
            # crawl interval is 5s; wait for A to find C via the book
            for _ in range(300):
                if c.node_key.node_id in a.switch.peers:
                    break
                await asyncio.sleep(0.1)
            assert c.node_key.node_id in a.switch.peers, (
                f"A peers: {list(a.switch.peers)}, book: {list(a.addr_book.addrs)}"
            )
        finally:
            for n in nodes:
                await n.stop()

    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        run(main())
    finally:
        sched_mod.set_scheduler(None)
        pv.set_engine(None)
        eng.close()


# --- bytes: the JAX book and messages --------------------------------------


def _fill(mod, rng_seed):
    """A book with seeded addresses, some proven, some failing."""
    rng = np.random.default_rng(rng_seed)
    book = mod.AddrBook(our_id="me")
    for i in range(40):
        pid = rng.bytes(20).hex()
        book.add_address(f"{pid}@10.0.{i}.{int(rng.integers(1, 255))}:{int(rng.integers(1024, 65535))}",
                         src="seed")
        if i % 3 == 0:
            book.mark_good(pid)
        if i % 7 == 0:
            book.mark_attempt(pid)
            book.mark_failed(pid)
    for ka in book.addrs.values():  # clock fields made equal across packages
        ka.last_attempt = ka.last_attempt and 1.0e9
        ka.last_success = ka.last_success and 2.0e9
        ka.last_failure = ka.last_failure and 3.0e9
    return book


def test_addrbook_file_matches_jax(tmp_path):
    files = {}
    for name, mod in (("port", ppex), ("jax", jpex)):
        book = _fill(mod, SEED)
        book.path = str(tmp_path / f"{name}.json")
        book.save()
        files[name] = book.path
    assert open(files["port"]).read() == open(files["jax"]).read()
    # each package reads the other's file to the same entries (the
    # attempts of 2001 forgiven on both sides)
    def entries(book):
        return {pid: (ka.addr, ka.attempts, ka.is_old, ka.failures, ka.last_failure)
                for pid, ka in book.addrs.items()}

    want = entries(ppex.AddrBook(files["port"], our_id="me"))
    assert len(want) == 40 and all(e[1] == 0 for e in want.values())
    assert sum(e[3] for e in want.values()) == 6
    assert entries(ppex.AddrBook(files["jax"], our_id="me")) == want
    assert entries(jpex.AddrBook(files["port"], our_id="me")) == want


class _Peer:
    def __init__(self, peer_id, outbound=True):
        self.peer_id = peer_id
        self.outbound = outbound
        self.sent = []

        class _Info:
            listen_addr = ""

        self.node_info = _Info()

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, bytes(msg)))
        return True


class _Switch:
    def __init__(self):
        self.stopped = []

    def stop_peer_for_error(self, peer, exc):
        self.stopped.append((peer.peer_id, str(exc)))


def _reactor(mod):
    r = mod.PexReactor(_fill(mod, SEED))
    r.switch = _Switch()
    return r


def test_pex_messages_match_jax_and_cross_decode():
    port, jax = _reactor(ppex), _reactor(jpex)
    wire = {}
    for name, r in (("port", port), ("jax", jax)):
        asker = _Peer("ab" * 20)
        r.add_peer(asker)  # an outbound peer is asked for addresses
        server = _Peer("cd" * 20, outbound=False)
        random.seed(SEED)  # the selection's shuffle
        r.receive(ppex.PEX_CHANNEL, server, bytes([ppex.MSG_PEX_REQUEST]))
        wire[name] = (asker.sent, server.sent)
    assert wire["port"] == wire["jax"]
    (req,), (resp,) = wire["port"]
    assert req == (0x00, bytes([ppex.MSG_PEX_REQUEST]))
    assert resp[1][0] == ppex.MSG_PEX_RESPONSE and len(json.loads(resp[1][1:])) == 40
    # each package learns the other's response from a peer it asked
    for mod, other in ((ppex, "jax"), (jpex, "port")):
        r = mod.PexReactor(mod.AddrBook(our_id="me"))
        r.switch = _Switch()
        asker = _Peer("ef" * 20)
        r.add_peer(asker)
        r.receive(0x00, asker, wire[other][1][0][1])
        assert r.book.size() == 40 and not r.switch.stopped
        # an unsolicited response is a protocol violation on both sides
        r.receive(0x00, asker, wire[other][1][0][1])
        assert r.switch.stopped == [("ef" * 20, "unsolicited PEX response")]


@pytest.mark.parametrize("mod", [ppex, jpex], ids=["port", "jax"])
def test_pex_unknown_message_type_raises(mod):
    r = _reactor(mod)
    with pytest.raises(ValueError, match="unknown pex msg type 9"):
        r.receive(0x00, _Peer("aa" * 20), bytes([9]))
