from .connection import ChannelStatus, MConnection
from .secret_connection import SecretConnection

__all__ = ["SecretConnection", "MConnection", "ChannelStatus"]
