"""What a routine that must not die caught: ``LoopErrors``, shared by
the blocksync pool routine, the consensus state machine and the p2p
switch (each counts a failed verify route in one, ROADMAP C3)."""

from __future__ import annotations

from collections import deque


class LoopErrors:
    """What the pool routine caught: ``count`` errors in all, the first
    ``KEEP`` and the last ``KEEP`` kept (their tracebacks dropped once
    logged, so a kept error holds no frame), and the kinds already
    logged. A card that fails every window costs a counter, not memory."""

    KEEP = 4
    MAX_KINDS = 256

    def __init__(self) -> None:
        self.count = 0
        self.first: list = []
        self.last: deque = deque(maxlen=self.KEEP)
        self._kinds: set = set()

    @staticmethod
    def kind(e: BaseException) -> tuple:
        return (type(e).__name__, str(e))

    def add(self, e: BaseException) -> bool:
        """Count ``e``; True when its kind is new (log its traceback)."""
        self.count += 1
        (self.first if len(self.first) < self.KEEP else self.last).append(e)
        k = self.kind(e)
        if k in self._kinds or len(self._kinds) >= self.MAX_KINDS:
            return False
        self._kinds.add(k)
        return True

    @staticmethod
    def drop_frames(e: BaseException) -> None:
        """Drop the tracebacks of ``e`` and of the errors it chains."""
        for _ in range(8):
            if e is None:
                return
            e.__traceback__ = None
            e = e.__cause__ or e.__context__

    def kept(self) -> list:
        return self.first + list(self.last)

    def __repr__(self) -> str:
        return f"LoopErrors(count={self.count}, kept={self.kept()!r})"
