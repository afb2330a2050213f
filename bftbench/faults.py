"""Faults planted under a run's timed path, for the control and the
tests: each must turn ``correct`` false.

- ``verify_off``: every lane of every verify ticket reads valid, on any
  route: the control, which breaks the guarantee both configurations
  state (nothing is served or applied before its commit is verified).
- ``half_batch``: the second half of each ticket's lanes is left out,
  read valid without a verdict.
- ``answer_altered``: the light plane serves each header with its app
  hash changed; the kvstore returns each block's app hash with a byte
  changed.
- ``state_unchanged``: the executor applies a block and hands back the
  state it was given.

``plant(name)`` installs one and returns the function that takes it out.
"""

from __future__ import annotations

import dataclasses


def _tickets(lanes):
    """Rewrite each ticket's verdicts as it resolves: ``lanes(oks)``."""
    from cometbft_tpu_torch.crypto import scheduler as S

    real = S.VerifyScheduler._finish

    def finish(self, ticket):
        lanes(ticket.oks)
        return real(self, ticket)

    S.VerifyScheduler._finish = finish
    return lambda: setattr(S.VerifyScheduler, "_finish", real)


def verify_off():
    def all_valid(oks):
        oks[:] = [True] * len(oks)

    return _tickets(all_valid)


def half_batch():
    def second_half(oks):
        half = len(oks) // 2
        oks[half:] = [True] * (len(oks) - half)

    return _tickets(second_half)


def answer_altered():
    from cometbft_tpu_torch.light.serving import LightServingPlane
    from cometbft_tpu_torch.models.kvstore import KVStoreApplication

    real_serve = LightServingPlane.serve
    real_finalize = KVStoreApplication.finalize_block

    def serve(self, height, session=None):
        lb = real_serve(self, height, session)
        return dataclasses.replace(lb, header=dataclasses.replace(lb.header, app_hash=b"\x01" * 32))

    def finalize(self, req):
        resp = real_finalize(self, req)
        resp.app_hash = bytes([resp.app_hash[0] ^ 1]) + resp.app_hash[1:]
        return resp

    LightServingPlane.serve = serve
    KVStoreApplication.finalize_block = finalize

    def undo():
        LightServingPlane.serve = real_serve
        KVStoreApplication.finalize_block = real_finalize

    return undo


def state_unchanged():
    from cometbft_tpu_torch.state.execution import BlockExecutor

    real = BlockExecutor.apply_verified_block

    def apply(self, state, block_id, block, *args, **kw):
        real(self, state, block_id, block, *args, **kw)
        return state

    BlockExecutor.apply_verified_block = apply
    return lambda: setattr(BlockExecutor, "apply_verified_block", real)


FAULTS = {"verify_off": verify_off, "half_batch": half_batch, "answer_altered": answer_altered,
          "state_unchanged": state_unchanged}


def plant(name: str):
    return FAULTS[name]()
