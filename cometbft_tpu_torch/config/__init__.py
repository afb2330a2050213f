from .config import (  # noqa: F401
    BaseConfig,
    Config,
    ConsensusConfig,
    default_config,
    test_config,
)
