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
switcher is the package ``lp2p/`` beside this one. Connection fuzzing
and trace stamping are not ported (``tracewire.py`` keeps only the
stamp framing a receiver must peel).
"""

from .key import NodeKey, node_id_from_pubkey
from .node_info import ChannelDescriptor, NodeInfo
from .peer import Peer
from .pex import AddrBook, KnownAddress, PexReactor
from .reactor import Reactor
from .reconnect import ReconnectPlane
from .switch import Switch
from .transport import MemoryTransport, TCPTransport

__all__ = [
    "NodeKey",
    "node_id_from_pubkey",
    "NodeInfo",
    "ChannelDescriptor",
    "Peer",
    "AddrBook",
    "KnownAddress",
    "PexReactor",
    "Reactor",
    "ReconnectPlane",
    "Switch",
    "TCPTransport",
    "MemoryTransport",
]
