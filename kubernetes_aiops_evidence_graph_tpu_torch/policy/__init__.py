from .engine import (
    ALLOWED_ACTIONS,
    HIGH_RISK_ACTIONS,
    PROTECTED_NAMESPACES,
    PolicyEngine,
    PolicyInput,
    PolicyResult,
    evaluate,
)

__all__ = [
    "PolicyEngine", "PolicyInput", "PolicyResult", "evaluate",
    "ALLOWED_ACTIONS", "HIGH_RISK_ACTIONS", "PROTECTED_NAMESPACES",
]
