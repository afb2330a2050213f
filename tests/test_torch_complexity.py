"""The committee-scale complexity plane of the port's bftlint, held to the
JAX package's: the cases of ``tests/test_complexity.py`` other than the
scaling probe's eight, which ``tests/test_torch_scaling.py`` already
ports.

- loop-domain classification (ASY117/118/119 beyond the basic
  fixtures): each source gives the port's ``analyze_source`` at
  ``cometbft_tpu_torch/consensus/x.py`` the rule IDs, lines and
  columns the JAX one gives at ``cometbft_tpu/consensus/x.py``, and
  the JAX case's own expectation;
- suppression hygiene over the port's tree: every suppression carries
  its reason, and the port's baseline entries match live findings;
- the CLI satellites (``--json`` payloads, ``--changed-only``);
- the hot-path fixes the pass drove, on the port's modules: the total
  voting power memo, the indexed ``update_with_change_set``, the
  per-peer vote cursor and the vote set's accept-order log.
"""

import io
import json
import re
import textwrap
import tokenize
from pathlib import Path

import pytest

from cometbft_tpu.analysis import analyze_source as janalyze_source
from cometbft_tpu_torch.analysis import analyze_source
from cometbft_tpu_torch.analysis.cli import main as cli_main
from torch_hard_limit import hard_limit  # noqa: F401

REPO_ROOT = Path(__file__).resolve().parents[1]
CONS = "cometbft_tpu_torch/consensus/x.py"
JCONS = "cometbft_tpu/consensus/x.py"


def findings_of(src: str, path: str = CONS):
    src = textwrap.dedent(src)
    found = analyze_source(src, path)
    jfound = janalyze_source(src, path.replace("cometbft_tpu_torch/", "cometbft_tpu/", 1))
    assert sorted((f.rule_id, f.line, f.col, f.chain, f.domain_trace) for f in found) == sorted(
        (f.rule_id, f.line, f.col, f.chain, f.domain_trace) for f in jfound
    )
    return found


def ids_of(src: str, path: str = CONS):
    return sorted({f.rule_id for f in findings_of(src, path)})


# --- loop-domain classification ----------------------------------------

DOMAIN_LOOPS = {
    "comprehension": """
    class R:
        def __init__(self, validators):
            self.validators = validators
        def receive(self, msg, peer):
            return [v.address for v in self.validators]
    """,
    "generator_expression": """
    class R:
        def __init__(self, validators):
            self.validators = validators
        def receive(self, msg, peer):
            return sum(v.power for v in self.validators)
    """,
    "zip_destructured_target": """
    class R:
        def __init__(self, validators, sigs):
            self.validators = validators
            self.sigs = sigs
        def receive(self, msg, peer):
            for v, s in zip(self.validators, self.sigs):
                print(v, s)
    """,
    "enumerate_destructured_target": """
    class R:
        def __init__(self, validators):
            self.validators = validators
        def receive(self, msg, peer):
            for i, v in enumerate(self.validators):
                print(i, v)
    """,
}


@pytest.mark.parametrize("shape", sorted(DOMAIN_LOOPS))
def test_loop_shape_carries_domain(shape):
    assert "ASY117" in ids_of(DOMAIN_LOOPS[shape])


def test_bounded_and_foreign_loops_stay_clean():
    src = """
    class R:
        def receive(self, msg, peer):
            for i in range(3):
                print(i)
            for ch in zip("abc", "def"):
                print(ch)
            for part in msg.parts:
                print(part)
    """
    assert "ASY117" not in ids_of(src)


def test_asy117_finding_carries_chain_and_domain_trace():
    src = """
    class R:
        def __init__(self, validators):
            self.validators = validators
        def receive(self, msg, peer):
            self._tally()
        def _tally(self):
            for v in self.validators:
                print(v)
    """
    hits = [f for f in findings_of(src) if f.rule_id == "ASY117"]
    assert hits
    f = hits[0]
    assert f.chain[0] == "receive" and len(f.chain) >= 2, f.chain
    assert f.domain_trace and "validators" in f.domain_trace[0]
    doc = f.to_json()
    assert doc["chain"] and doc["domain_trace"]


def test_asy117_suppressed_loop_line_sanctions_the_chain():
    src = """
    class R:
        def __init__(self, validators):
            self.validators = validators
        def receive(self, msg, peer):
            self._tally()
        def _tally(self):
            for v in self.validators:  # bftlint: disable=ASY117 — once per height, memoized upstream
                print(v)
    """
    assert "ASY117" not in ids_of(src)


def test_asy118_call_inside_committee_loop_reaching_committee_loop():
    src = """
    from typing import Sequence
    def scan(changes: Sequence[Validator], addr):
        for c in changes:
            if c.address == addr:
                return c
    def update(validators, changes: Sequence[Validator]):
        for v in validators:
            scan(changes, v.address)
    """
    assert [f for f in findings_of(src) if f.rule_id == "ASY118"]


def test_asy118_inner_line_suppression():
    src = """
    from typing import Sequence
    def update(validators, changes: Sequence[Validator]):
        for v in validators:
            for c in changes:  # bftlint: disable=ASY118 — churn sets are tiny in practice, measured by the scaling leg
                print(v, c)
    """
    assert "ASY118" not in ids_of(src)


def test_asy119_alias_prune_is_seen():
    src = """
    class R:
        def __init__(self):
            self._q = []
        def receive(self, msg, peer):
            self._q.append(msg)
        def drain(self):
            fifo = self._q
            while fifo:
                fifo.pop(0)
    """
    assert "ASY119" not in ids_of(src)


def test_asy119_registration_growth_is_not_hot():
    src = """
    class R:
        def __init__(self):
            self.reactors = []
        def add_reactor(self, r):
            self.reactors.append(r)
    """
    assert "ASY119" not in ids_of(src)


def test_asy119_suppressed_init_line():
    src = """
    class R:
        def __init__(self):
            self.log = []  # bftlint: disable=ASY119 — bounded by validator count, dropped per height
        def receive(self, msg, peer):
            self.log.append(msg)
    """
    assert "ASY119" not in ids_of(src)


# --- suppression hygiene over the port --------------------------------

_DIRECTIVE = re.compile(
    r"#\s*bftlint:\s*disable(?:-next|-file)?\s*=\s*"
    r"[A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*"
)


def test_every_suppression_carries_a_justification():
    offenders = []
    count = 0
    for path in (REPO_ROOT / "cometbft_tpu_torch").rglob("*.py"):
        src = path.read_text(encoding="utf-8")
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _DIRECTIVE.search(tok.string)
            if m is None:
                continue
            count += 1
            tail = tok.string[m.end():].strip().strip("—-: ").strip()
            if len(tail) < 15:
                offenders.append(f"{path.relative_to(REPO_ROOT)}:{tok.start[0]}: {tok.string.strip()}")
    assert not offenders, "suppressions without justification:\n" + "\n".join(offenders)
    assert count > 0


def test_baseline_entries_match_live_findings():
    from cometbft_tpu_torch.analysis import baseline as baseline_mod
    from cometbft_tpu_torch.analysis.cli import DEFAULT_BASELINE
    from cometbft_tpu_torch.analysis.engine import run

    bl = baseline_mod.load(str(DEFAULT_BASELINE))
    findings = run([str(REPO_ROOT / "cometbft_tpu_torch")])
    _, stale = baseline_mod.apply(findings, bl)
    assert not stale, "\n".join(s.render() for s in stale)


# --- CLI satellites ----------------------------------------------------

_HANDLER = """
class R:
    def __init__(self, validators):
        self.validators = validators
    def receive(self, msg, peer):
        self._tally()
    def _tally(self):
        for v in self.validators:
            print(v)
"""


def test_cli_json_emits_chain_and_domain_trace(tmp_path, capsys):
    shadow = tmp_path / "cometbft_tpu_torch" / "consensus"
    shadow.mkdir(parents=True)
    (shadow / "x.py").write_text(_HANDLER)
    rc = cli_main([str(tmp_path / "cometbft_tpu_torch"), "--json", "--no-baseline"])
    out = capsys.readouterr().out
    assert rc == 1
    hits = [f for f in json.loads(out)["findings"] if f["rule_id"] == "ASY117"]
    assert hits
    assert hits[0]["chain"] and hits[0]["domain_trace"]


def test_cli_changed_only_scopes_the_report(tmp_path, capsys, monkeypatch):
    from cometbft_tpu_torch.analysis import cli as cli_mod

    shadow = tmp_path / "cometbft_tpu_torch" / "consensus"
    shadow.mkdir(parents=True)
    target = shadow / "x.py"
    target.write_text(textwrap.dedent("""
        class R:
            def __init__(self, validators):
                self.validators = validators
            def receive(self, msg, peer):
                for v in self.validators:
                    print(v)
    """))
    args = [str(tmp_path / "cometbft_tpu_torch"), "--no-baseline", "--changed-only"]
    monkeypatch.setattr(cli_mod, "_git_changed_files", lambda: {str(target.as_posix())})
    assert cli_main(args) == 1
    capsys.readouterr()
    monkeypatch.setattr(cli_mod, "_git_changed_files", lambda: set())
    assert cli_main(args) == 0
    assert "clean" in capsys.readouterr().out


# --- hot-path fixes the pass drove, on the port's modules ----------------


def test_total_voting_power_memo_invalidates_on_churn():
    from cometbft_tpu_torch.analysis.scaling import _committee
    from cometbft_tpu_torch.types.validator_set import Validator

    vs, _, _, _ = _committee(4)
    assert vs.total_voting_power() == 40
    assert vs.total_voting_power() == 40
    v0 = vs.validators[0]
    vs.update_with_change_set([Validator(v0.pub_key, 25, v0.address)])
    assert vs.total_voting_power() == 55
    vs.update_with_change_set([Validator(v0.pub_key, 0, v0.address)])
    assert vs.total_voting_power() == 30
    cp = vs.copy()
    assert cp.total_voting_power() == 30


def test_update_with_change_set_indexing_parity():
    """The port's indexed update against the JAX package's on the same
    change set: the same powers and the same proposer priorities."""
    from cometbft_tpu.analysis.scaling import _committee as _jcommittee
    from cometbft_tpu.crypto.keys import PubKey as JPubKey
    from cometbft_tpu.types.validator_set import Validator as JValidator
    from cometbft_tpu_torch.analysis.scaling import _committee
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types.validator_set import Validator

    def apply(committee, pub, val):
        vs, _, _, _ = committee(6)
        before = {v.address: v.voting_power for v in vs.validators}
        a_upd, a_del = vs.validators[1], vs.validators[4]
        new_pk = pub(bytes([9]) + (77).to_bytes(31, "big"))
        vs.update_with_change_set([
            val(a_upd.pub_key, 42, a_upd.address),
            val(a_del.pub_key, 0, a_del.address),
            val(new_pk, 7),
        ])
        after = {v.address: v.voting_power for v in vs.validators}
        assert after[a_upd.address] == 42
        assert a_del.address not in after
        assert after[new_pk.address()] == 7
        for addr, power in before.items():
            if addr not in (a_upd.address, a_del.address):
                assert after[addr] == power
        assert vs.total_voting_power() == sum(after.values())
        new_val = next(v for v in vs.validators if v.address == new_pk.address())
        assert all(new_val.proposer_priority < v.proposer_priority
                   for v in vs.validators if v.address != new_val.address)
        return [(v.address, v.voting_power, v.proposer_priority) for v in vs.validators]

    assert apply(_committee, PubKey, Validator) == apply(_jcommittee, JPubKey, JValidator)


def _cursor_world(n=4):
    from cometbft_tpu_torch.analysis.scaling import _committee
    from cometbft_tpu_torch.consensus.reactor import PeerRoundState, PeerVoteCursor, _vote_key
    from cometbft_tpu_torch.types.vote import PRECOMMIT
    from cometbft_tpu_torch.types.vote_set import VoteSet

    valset, votes, chain_id, height = _committee(n)
    precommits = VoteSet(chain_id, height, 0, PRECOMMIT, valset, verify_signatures=False)

    class _HVS:
        def prevotes(self, r):
            return None

        def precommits(self, r):
            return precommits if r == 0 else None

    class _RS:
        pass

    rs = _RS()
    rs.height, rs.round = height, 0
    rs.votes, rs.last_commit = _HVS(), None
    prs = PeerRoundState(height=height, round=0)
    cur = PeerVoteCursor()
    cur.reset(height)
    return cur, rs, prs, precommits, votes, _vote_key


def test_peer_vote_cursor_delivers_then_retransmits_then_acks():
    cur, rs, prs, precommits, votes, _vote_key = _cursor_world()
    for v in votes[:2]:
        precommits.add_vote(v)
    cur.ingest(rs, prs)
    due = cur.due_votes(prs, now=10.0, budget=16)
    assert {_vote_key(v) for v in due} == {_vote_key(v) for v in votes[:2]}
    assert cur.due_votes(prs, now=10.1, budget=16) == []
    again = cur.due_votes(prs, now=10.4, budget=16)
    assert len(again) == 2
    prs.has_votes.add(_vote_key(votes[0]))
    later = cur.due_votes(prs, now=11.0, budget=16)
    assert [_vote_key(v) for v in later] == [_vote_key(votes[1])]
    assert _vote_key(votes[0]) not in cur.pending


def test_peer_vote_cursor_is_incremental_not_rescanning():
    cur, rs, prs, precommits, votes, _vote_key = _cursor_world()
    for v in votes:
        precommits.add_vote(v)
        prs.has_votes.add(_vote_key(v))
    cur.ingest(rs, prs)
    cur.due_votes(prs, now=1.0, budget=16)
    assert cur.pending == {}
    read_before = dict(cur._read)
    cur.ingest(rs, prs)
    assert cur._read == read_before
    assert cur.due_votes(prs, now=2.0, budget=16) == []


def test_peer_vote_cursor_resets_on_height_advance():
    cur, rs, prs, precommits, votes, _vote_key = _cursor_world()
    precommits.add_vote(votes[0])
    cur.ingest(rs, prs)
    assert cur.pending
    cur.reset(rs.height + 1)
    assert cur.pending == {} and cur._read == {}
    assert cur.height == rs.height + 1


def test_vote_set_log_appends_in_accept_order():
    cur, rs, prs, precommits, votes, _vote_key = _cursor_world()
    precommits.add_vote(votes[2])
    precommits.add_vote(votes[0])
    assert [v.validator_index for v in precommits.vote_log] == [2, 0]
    precommits.add_vote(votes[2])
    assert [v.validator_index for v in precommits.vote_log] == [2, 0]
