from .engine import (
    NonRetryableError,
    RetryPolicy,
    Step,
    StepFailed,
    WorkflowEngine,
    WorkflowFenced,
)
from .incident_workflow import (
    IncidentContext,
    incident_steps,
    run_incident_workflow,
)
from .worker import IncidentWorker

__all__ = [
    "WorkflowEngine", "Step", "RetryPolicy", "StepFailed", "NonRetryableError",
    "WorkflowFenced", "IncidentContext", "incident_steps",
    "run_incident_workflow", "IncidentWorker",
]
