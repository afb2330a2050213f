"""The in-process ABCI client (reference abci/client/local_client.go).

The part of the JAX package's ``abci/client.py`` that a node with a
local app uses: ``LocalClient`` serializes every call on one lock, as
the reference's local client does with its mutex, and ``AppConns``
names the logical connections over it. Socket and gRPC clients are
not ported.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import types as abci


class LocalClient:
    def __init__(self, app: abci.Application, lock: Optional[threading.RLock] = None):
        self.app = app
        # one lock across the connections: the reference's global mutex
        self._lock = lock or threading.RLock()

    # consensus connection
    def init_chain(self, req):
        with self._lock:
            return self.app.init_chain(req)

    def prepare_proposal(self, req):
        with self._lock:
            return self.app.prepare_proposal(req)

    def process_proposal(self, req):
        with self._lock:
            return self.app.process_proposal(req)

    def extend_vote(self, req):
        with self._lock:
            return self.app.extend_vote(req)

    def verify_vote_extension(self, req):
        with self._lock:
            return self.app.verify_vote_extension(req)

    def finalize_block(self, req):
        with self._lock:
            return self.app.finalize_block(req)

    def commit(self):
        with self._lock:
            return self.app.commit()

    # mempool connection
    def check_tx(self, req):
        with self._lock:
            return self.app.check_tx(req)

    # info connection
    def info(self, req):
        with self._lock:
            return self.app.info(req)

    def query(self, req):
        with self._lock:
            return self.app.query(req)


class AppConns:
    """Named logical connections sharing one client (reference
    proxy/multi_app_conn.go: consensus, mempool, query)."""

    def __init__(self, client, mempool=None, query=None):
        self.consensus = client
        self.mempool = mempool or client
        self.query = query or client

    @classmethod
    def local(cls, app: abci.Application) -> "AppConns":
        return cls(LocalClient(app))
