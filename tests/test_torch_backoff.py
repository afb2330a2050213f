"""The port's shared reconnect/retry backoff (utils/backoff.py:
exponential + full jitter + cap) held to the JAX package's: every case
of ``tests/test_backoff.py`` on cometbft_tpu_torch, with the seeded
schedules compared with the JAX ``Backoff``'s."""

import random

import pytest

from cometbft_tpu.utils.backoff import Backoff as JBackoff
from cometbft_tpu_torch.utils.backoff import Backoff


def test_ceiling_grows_exponentially_to_cap():
    b = Backoff(base_s=1.0, cap_s=30.0, rng=random.Random(1))
    ceilings = []
    for _ in range(8):
        ceilings.append(b.ceiling())
        b.next_delay()
    assert ceilings == [1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 30.0, 30.0]


def test_full_jitter_bounds_and_determinism():
    a = Backoff(base_s=0.5, cap_s=8.0, rng=random.Random(7))
    b = Backoff(base_s=0.5, cap_s=8.0, rng=random.Random(7))
    j = JBackoff(base_s=0.5, cap_s=8.0, rng=random.Random(7))
    da = [a.next_delay() for _ in range(20)]
    db = [b.next_delay() for _ in range(20)]
    assert da == db  # seeded => deterministic schedule
    assert da == [j.next_delay() for _ in range(20)]  # and the JAX one's
    cap = 0.5
    for d in da:
        assert 0.0 <= d <= min(8.0, cap)
        cap = min(cap * 2, 8.0)


def test_reset_restarts_the_schedule():
    b = Backoff(base_s=1.0, cap_s=30.0, rng=random.Random(3))
    for _ in range(5):
        b.next_delay()
    assert b.ceiling() == 30.0
    b.reset()
    assert b.ceiling() == 1.0


def test_rejects_nonsense_parameters():
    for kw in ({"base_s": 0.0}, {"base_s": 2.0, "cap_s": 1.0}, {"factor": 0.5}):
        with pytest.raises(ValueError):
            Backoff(**kw)


def test_switch_reconnect_uses_shared_backoff():
    """The reconnect plane constructs the shared Backoff (no second
    hand-rolled schedule); both switch flavors share the plane by
    inheritance (Lp2pSwitch subclasses Switch, which owns a
    ReconnectPlane)."""
    import inspect

    from cometbft_tpu_torch.lp2p.switch import Lp2pSwitch
    from cometbft_tpu_torch.p2p.reconnect import ReconnectPlane
    from cometbft_tpu_torch.p2p.switch import Switch

    assert "Backoff(" in inspect.getsource(ReconnectPlane._backoff_for)
    assert "reconnect" not in vars(Lp2pSwitch), "Lp2pSwitch must inherit the Switch reconnect plane"
    assert not hasattr(Switch, "_schedule_reconnect"), "the old finite-attempts reconnect routine is gone"
