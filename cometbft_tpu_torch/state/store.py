"""State store: the state, validator sets, params and ABCI responses
by height (reference state/store.go).

A copy of the JAX package's ``state/store.py``. Key layout:
  S:state            -> latest State (slim: valset membership by
                        reference, exact proposer priorities inline)
  S:vi:<height>      -> ValidatorsInfo for height: the full set when it
                        changed at <height> (or at a checkpoint), else
                        a pointer {last_height_changed}
  S:vals:<height>    -> legacy full ValidatorSet records (read-only
                        fallback for stores written before the pointer
                        scheme)
  S:params:<height>  -> ConsensusParams active at height
  S:abci:<height>    -> FinalizeBlock response (tx results etc.)

The pointer scheme is the reference's ValidatorsInfo design
(state/store.go:185-251): the full validator set is written only when
it changes or every VALSET_CHECKPOINT_INTERVAL heights; a load in
between rebuilds proposer priorities by incrementing from the last
full set. The live state's priorities never take that path: S:state
carries the three exact priority vectors. ``bootstrap`` saves a
state obtained out of band (statesync) with full records only;
``prune_states`` keeps the full record every retained pointer record
anchors at.
"""

from __future__ import annotations

from typing import Optional

from ..types.validator_set import ValidatorSet
from ..utils import codec, kv, proto, wirecodec
from .state_types import ConsensusParams, State

# full-set checkpoint cadence for unchanged valsets (see module doc)
VALSET_CHECKPOINT_INTERVAL = 1_000


def _h(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


def _encode_prio_vector(vs: ValidatorSet) -> bytes:
    """Packed exact priorities and proposer index of one valset: the
    count, one (possibly negative, so 10-byte) varint per validator in
    stored order, then proposer_index+1 (0 = no proposer). Three encode
    a replayed height, so the varints take the native bulk encoder
    (``utils/wirecodec.py``) when it is built."""
    prop_idx = 0
    if vs.proposer is not None:
        prop_idx = vs._by_address.get(vs.proposer.address, -1) + 1
    nums = [len(vs.validators)]
    nums.extend(v.proposer_priority for v in vs.validators)
    nums.append(prop_idx)
    nat = wirecodec.module()
    if nat is not None:
        try:
            return nat.varints(nums)
        except Exception:  # pragma: no cover - priorities past 64 bits
            pass
    out = bytearray()
    for x in nums:
        out += proto.varint(x)
    return bytes(out)


def _apply_prio_vector(vs: ValidatorSet, b: bytes) -> ValidatorSet:
    n, pos = proto.read_varint(b, 0)
    if n != len(vs.validators):
        raise ValueError(
            f"priority vector length {n} != valset size {len(vs.validators)}"
        )
    for v in vs.validators:
        v.proposer_priority, pos = proto.read_varint(b, pos)
    prop_idx, pos = proto.read_varint(b, pos)
    vs.proposer = vs.validators[prop_idx - 1] if prop_idx else None
    return vs


def encode_state(s: State, embed_valsets: bool = True) -> bytes:
    """State blob. ``embed_valsets=True`` (wire/tool form) embeds the
    full validator sets; the store's slim form (False) writes only the
    exact priority vectors (fields 14-16) and reconstructs membership
    from the S:vi records on load."""
    out = proto.field_string(1, s.chain_id)
    out += proto.field_varint(2, s.initial_height)
    out += proto.field_varint(3, s.last_block_height)
    out += proto.field_message(4, s.last_block_id.encode())
    out += proto.field_varint(5, s.last_block_time_ns)
    if embed_valsets:
        if s.validators:
            out += proto.field_message(
                6, codec.encode_validator_set(s.validators)
            )
        if s.next_validators:
            out += proto.field_message(
                7, codec.encode_validator_set(s.next_validators)
            )
        if s.last_validators and s.last_validators.size() > 0:
            out += proto.field_message(
                8, codec.encode_validator_set(s.last_validators)
            )
    out += proto.field_varint(9, s.last_height_validators_changed)
    out += proto.field_message(10, s.consensus_params.encode())
    out += proto.field_varint(11, s.last_height_consensus_params_changed)
    out += proto.field_bytes(12, s.last_results_hash)
    out += proto.field_bytes(13, s.app_hash)
    if not embed_valsets:
        if s.validators:
            out += proto.field_bytes(14, _encode_prio_vector(s.validators))
        if s.next_validators:
            out += proto.field_bytes(
                15, _encode_prio_vector(s.next_validators)
            )
        if s.last_validators and s.last_validators.size() > 0:
            out += proto.field_bytes(
                16, _encode_prio_vector(s.last_validators)
            )
    return out


def decode_state(b: bytes) -> State:
    """Decode a state blob. For the slim form the valset fields come
    back None and the packed priority vectors are stashed on the State
    as ``_prio_vectors`` for Store.load() to overlay."""
    m = proto.parse(b)

    def vs(f):
        raw = proto.get1(m, f)
        return codec.decode_validator_set(raw) if raw else None

    st = State(
        chain_id=proto.get1(m, 1, b"").decode(),
        initial_height=proto.get1(m, 2, 1),
        last_block_height=proto.get1(m, 3, 0),
        last_block_id=codec.decode_block_id(proto.get1(m, 4, b"")),
        last_block_time_ns=proto.get1(m, 5, 0),
        validators=vs(6),
        next_validators=vs(7),
        last_validators=vs(8) or ValidatorSet.__new__(ValidatorSet),
        last_height_validators_changed=proto.get1(m, 9, 0),
        consensus_params=ConsensusParams.decode(proto.get1(m, 10, b"")),
        last_height_consensus_params_changed=proto.get1(m, 11, 0),
        last_results_hash=proto.get1(m, 12, b""),
        app_hash=proto.get1(m, 13, b""),
    )
    if st.validators is None:
        st._prio_vectors = (
            proto.get1(m, 14),
            proto.get1(m, 15),
            proto.get1(m, 16),
        )
    return st


# --- ValidatorsInfo records (reference state/store.go:185-251) ---------


def _encode_validators_info(
    vs: Optional[ValidatorSet], last_height_changed: int
) -> bytes:
    out = b""
    if vs is not None:
        out += proto.field_message(1, codec.encode_validator_set(vs))
    out += proto.field_varint(2, last_height_changed)
    return out


def _decode_validators_info(b: bytes):
    m = proto.parse(b)
    raw = proto.get1(m, 1)
    vs = codec.decode_validator_set(raw) if raw else None
    return vs, proto.get1(m, 2, 0)


def _last_stored_height_for(height: int, last_height_changed: int) -> int:
    checkpoint = height - height % VALSET_CHECKPOINT_INTERVAL
    return max(checkpoint, last_height_changed)


class Store:
    def __init__(self, db: kv.KV):
        self.db = db
        # highest height save() wrote in THIS instance: contiguous
        # successor saves skip the backfill/anchor existence probes
        # (their records were written by the previous save)
        self._last_saved_height: Optional[int] = None

    def load(self) -> Optional[State]:
        b = self.db.get(b"S:state")
        if b is None:
            return None
        st = decode_state(b)
        if st.validators is None and hasattr(st, "_prio_vectors"):
            # slim blob: membership from the S:vi records, EXACT
            # priorities + proposer from the inline vectors
            pv, pnv, plv = st._prio_vectors
            h = st.last_block_height
            st.validators = self.load_validators(
                h + 1, membership_only=bool(pv)
            )
            st.next_validators = self.load_validators(
                h + 2, membership_only=bool(pnv)
            )
            st.last_validators = (
                self.load_validators(h, membership_only=bool(plv))
                if h > 0
                else None
            )
            if st.validators is None or st.next_validators is None:
                raise ValueError(
                    "state blob references missing validator records "
                    f"at heights {h + 1}/{h + 2}"
                )
            if pv:
                _apply_prio_vector(st.validators, pv)
            if pnv:
                _apply_prio_vector(st.next_validators, pnv)
            if plv and st.last_validators is not None:
                _apply_prio_vector(st.last_validators, plv)
            del st._prio_vectors
        if st.last_validators is not None and not hasattr(
            st.last_validators, "validators"
        ):
            st.last_validators = None
        return st

    def save(self, state: State) -> None:
        next_height = state.last_block_height + 1
        contiguous = (
            self._last_saved_height is not None
            and state.last_block_height == self._last_saved_height + 1
        )
        sets = []
        if next_height == state.initial_height:
            # genesis: record both current and next valsets (both are
            # change points: the set "changed into existence")
            sets.append(
                (
                    _h(b"S:vi:", next_height),
                    _encode_validators_info(state.validators, next_height),
                )
            )
        elif not contiguous:
            # out-of-band saves (a state not evolved height-by-height
            # through this store — tests, tools, migrations, a fresh
            # Store instance) may lack the records earlier saves would
            # have written; backfill them full so load() can always
            # reconstruct. Contiguous successor saves skip the probes:
            # the previous save wrote these records (replay hot path).
            for hh, vs in (
                (next_height, state.validators),
                (state.last_block_height, state.last_validators),
            ):
                if (
                    vs is not None
                    and getattr(vs, "validators", None)
                    and self.db.get(_h(b"S:vi:", hh)) is None
                    and self.db.get(_h(b"S:vals:", hh)) is None
                ):
                    sets.append(
                        (
                            _h(b"S:vi:", hh),
                            _encode_validators_info(vs, hh),
                        )
                    )
        k = next_height + 1
        changed = state.last_height_validators_changed
        full = (
            k == changed
            or k % VALSET_CHECKPOINT_INTERVAL == 0
            or k <= state.initial_height + 1
            # a change marker above this record must never become a
            # forward pointer
            or changed > k
        )
        if not full and not contiguous:
            # never write a dangling pointer: the referenced full
            # record must already exist (it can be absent after an
            # out-of-band save — e.g. a state constructed directly by
            # tests/tools rather than evolved from genesis)
            k0 = _last_stored_height_for(k, changed)
            full = (
                self.db.get(_h(b"S:vi:", k0)) is None
                and self.db.get(_h(b"S:vals:", k0)) is None
            )
        sets.append(
            (
                _h(b"S:vi:", k),
                _encode_validators_info(
                    state.next_validators if full else None, changed
                ),
            )
        )
        sets.append((b"S:state", encode_state(state, embed_valsets=False)))
        sets.append(
            (_h(b"S:params:", next_height), state.consensus_params.encode())
        )
        self.db.write_batch(sets)
        self._last_saved_height = state.last_block_height

    def bootstrap(self, state: State) -> None:
        """Save a state obtained out of band (statesync), with history
        gaps (reference state/store.go Bootstrap): every record is a
        full set — there is no contiguous history to point into."""
        h = state.last_block_height
        sets = [(b"S:state", encode_state(state, embed_valsets=False))]
        if state.last_validators is not None and getattr(state.last_validators, "validators", None):
            sets.append((_h(b"S:vi:", h), _encode_validators_info(state.last_validators, h)))
        sets.append(
            (_h(b"S:vi:", h + 1),
             _encode_validators_info(state.validators, state.last_height_validators_changed))
        )
        sets.append(
            (_h(b"S:vi:", h + 2),
             _encode_validators_info(state.next_validators, state.last_height_validators_changed))
        )
        sets.append((_h(b"S:params:", h + 1), state.consensus_params.encode()))
        self.db.write_batch(sets)

    def load_validators(
        self, height: int, membership_only: bool = False
    ) -> Optional[ValidatorSet]:
        """Valset for ``height``; pointer records reconstruct proposer
        priorities by incrementing from the last stored full set
        (reference state/store.go:545-588 — and the same approximation
        caveat, see module doc). ``membership_only`` skips the priority
        reconstruction (up to checkpoint-interval increment passes) for
        callers that overlay exact priorities anyway (load())."""
        b = self.db.get(_h(b"S:vi:", height))
        if b is None:
            # legacy record (pre-pointer-scheme store)
            b = self.db.get(_h(b"S:vals:", height))
            return codec.decode_validator_set(b) if b else None
        vs, changed = _decode_validators_info(b)
        if vs is not None:
            return vs
        k0 = _last_stored_height_for(height, changed)
        b0 = self.db.get(_h(b"S:vi:", k0))
        if b0 is not None:
            vs = _decode_validators_info(b0)[0]
        else:  # the stored-full height predates the scheme: legacy record
            raw = self.db.get(_h(b"S:vals:", k0))
            vs = codec.decode_validator_set(raw) if raw else None
        if vs is None:
            raise ValueError(
                f"validators at height {height} point to missing full "
                f"record at {k0}"
            )
        if not membership_only:
            vs.increment_proposer_priority(height - k0)
        return vs

    def load_consensus_params(self, height: int) -> Optional[ConsensusParams]:
        b = self.db.get(_h(b"S:params:", height))
        if b is not None:
            return ConsensusParams.decode(b)
        # walk back to the last change checkpoint
        for hh in range(height, 0, -1):
            b = self.db.get(_h(b"S:params:", hh))
            if b is not None:
                return ConsensusParams.decode(b)
        return None

    def save_finalize_block_response(self, height: int, encoded: bytes) -> None:
        self.db.set(_h(b"S:abci:", height), encoded)

    def load_finalize_block_response(self, height: int) -> Optional[bytes]:
        return self.db.get(_h(b"S:abci:", height))

    def prune_states(self, retain_height: int) -> None:
        """Delete state records below ``retain_height``, keeping the
        full record every retained pointer record anchors at
        (reference state/store.go:299 keeps the last checkpoint). The
        floor is the anchor of the first pointer record at or above
        retain_height: anchors max(checkpoint(h), changed) are monotone
        in h, so it bounds every later one. Full records on the way are
        skipped, not trusted as a floor: save()'s backfill writes full
        records that are not change points, so a pointer above one can
        still anchor below it (a legacy ``S:vals`` record included)."""
        keep_from = retain_height
        for k, v in self.db.iter_prefix(b"S:vi:"):
            h = int.from_bytes(k[len(b"S:vi:") :], "big")
            if h < retain_height:
                continue
            vs, changed = _decode_validators_info(v)
            if vs is None:
                keep_from = min(keep_from, _last_stored_height_for(h, changed))
                break
        deletes = []
        for prefix in (b"S:vi:", b"S:vals:"):
            for k, _ in self.db.iter_prefix(prefix):
                if int.from_bytes(k[len(prefix) :], "big") < keep_from:
                    deletes.append(k)
        for k, _ in self.db.iter_prefix(b"S:abci:"):
            if int.from_bytes(k[len(b"S:abci:") :], "big") < retain_height:
                deletes.append(k)
        if deletes:
            self.db.write_batch([], deletes)
