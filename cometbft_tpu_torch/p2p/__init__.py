"""P2P layer: authenticated-encrypted TCP transport, multiplexed
channels, peer lifecycle, switch + reactor plumbing.

The port of the JAX package's ``p2p/`` (reference -> here):
- p2p/key.go              -> key.py (NodeKey, ID derivation)
- p2p/conn/secret_connection.go -> conn/secret_connection.py
- p2p/conn/connection.go  -> conn/connection.py (MConnection)
- p2p/transport.go        -> transport.py (TCP + in-memory)
- p2p/peer.go             -> peer.py
- p2p/switch.go           -> switch.py (+ reconnect.py: the
  self-healing never-give-up redial plane, fork addition)
- p2p/base_reactor.go     -> reactor.py
- p2p/pex/                -> pex.py (addrbook + PEX reactor)

Wire layouts, channel ids and handshakes are the JAX package's, byte
for byte: a port node and a JAX node peer with each other. The lp2p
switcher is the package ``lp2p/`` beside this one. Trace stamping is
``tracewire.py``'s, byte for byte; connection fuzzing is ``fuzz.py``'s,
and the chaos harness's link plane (``chaos/links.py``) wraps the
in-memory transport's connections through ``MemoryTransport``'s
``link_hook``.

The names below load their modules on first use, so that a process
that needs only the node key or the secret connection (the command
line's ``init`` and ``signer``) does not import the switch, and with it
the verify scheduler and torch.
"""

import importlib

_WHERE = {
    "NodeKey": "key",
    "node_id_from_pubkey": "key",
    "NodeInfo": "node_info",
    "ChannelDescriptor": "node_info",
    "Peer": "peer",
    "AddrBook": "pex",
    "KnownAddress": "pex",
    "PexReactor": "pex",
    "Reactor": "reactor",
    "ReconnectPlane": "reconnect",
    "Switch": "switch",
    "TCPTransport": "transport",
    "MemoryTransport": "transport",
}

__all__ = list(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
