from .compensator import RemediationCompensator
from .executor import RESTART_CLASS, RemediationExecutor
from .orchestrator import ACTION_RISKS, RemediationOrchestrator
from .verifier import RemediationVerifier

__all__ = [
    "ACTION_RISKS", "RESTART_CLASS", "RemediationOrchestrator",
    "RemediationExecutor", "RemediationCompensator", "RemediationVerifier",
]
