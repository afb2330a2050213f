from .config import (  # noqa: F401
    BaseConfig,
    Config,
    ConsensusConfig,
    default_config,
    load_toml,
    test_config,
    write_toml,
)
