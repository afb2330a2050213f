"""lp2p: alternative stream-multiplexed p2p stack (fork feature).

The reference fork carries `lp2p/` — a second `p2p.Switcher`
implementation over go-libp2p where every legacy channel byte maps to
its own libp2p protocol/stream (`lp2p/stream.go:28`), with a resource
manager and connection gater (`lp2p/host.go:54-301`), selected by
config at `node/node.go:476-575`.

The port of the JAX package's ``lp2p/``: the secret-connection
handshake is reused from ``p2p.conn``, and a lightweight yamux-style
stream multiplexer gives each reactor channel an independent stream
over the encrypted connection — so a slow blocksync transfer cannot
head-of-line-block consensus votes the way a single shared MConnection
stream could. Reactor messages drain through the auto-scaling worker
pool (``utils.autopool``) when the switch is built with
``use_autopool``. Frames and protocol ids are the JAX package's, byte
for byte: a port node and a JAX node peer over lp2p.
"""

from .mux import Muxer, MuxStream, MuxError  # noqa: F401
from .host import Host, ConnGater, ResourceManager, ResourceError  # noqa: F401
from .switch import Lp2pSwitch, Lp2pPeer  # noqa: F401
