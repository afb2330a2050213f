import importlib

_WHERE = {"SecretConnection": "secret_connection", "MConnection": "connection", "ChannelStatus": "connection"}

__all__ = ["SecretConnection", "MConnection", "ChannelStatus"]


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
