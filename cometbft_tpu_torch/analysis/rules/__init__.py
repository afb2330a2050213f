"""Built-in bftlint rules; importing this package registers them."""
from . import (  # noqa: F401
    async_rules,
    complexity_rules,
    finalize_rules,
    interproc_rules,
    torch_rules,
    trace_rules,
)
