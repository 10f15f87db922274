"""Slack integration — approval requests with a REAL response path.

The reference posts a Block Kit message and then always returns
not-approved/pending because no interactive callback exists
(slack_client.py:47-54, SURVEY.md §3.6 item 8). Here approvals are
first-class: requests are registered in an ApprovalBroker that the HTTP
API's /approvals endpoints resolve (or tests resolve directly), and the
Slack webhook post is just a notification transport — gated on
configuration, with an offline queue when no URL is set.
"""
from __future__ import annotations

import json
import threading
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

from ..config import Settings, get_settings
from ..models import ApprovalRequest, ApprovalResponse
from ..utils.timeutils import utcnow


@dataclass
class _Pending:
    request: ApprovalRequest
    event: threading.Event = field(default_factory=threading.Event)
    response: Optional[ApprovalResponse] = None


class ApprovalBroker:
    """In-process approval registry: request → (wait | resolve)."""

    def __init__(self) -> None:
        self._pending: dict[str, _Pending] = {}
        self._lock = threading.Lock()

    def register(self, request: ApprovalRequest) -> str:
        key = str(request.action_id)
        with self._lock:
            self._pending[key] = _Pending(request=request)
        return key

    def resolve(self, action_id: str, approved: bool, responder: str = "operator",
                notes: str | None = None) -> bool:
        with self._lock:
            p = self._pending.get(str(action_id))
            if p is None:
                return False
            p.response = ApprovalResponse(
                action_id=p.request.action_id, approved=approved,
                responder=responder, responded_at=utcnow(), notes=notes)
            p.event.set()
            return True

    def wait(self, action_id: str, timeout_s: float) -> Optional[ApprovalResponse]:
        with self._lock:
            p = self._pending.get(str(action_id))
        if p is None:
            return None
        p.event.wait(timeout_s)
        with self._lock:
            self._pending.pop(str(action_id), None)
        return p.response

    def pending(self) -> list[ApprovalRequest]:
        with self._lock:
            return [p.request for p in self._pending.values()
                    if p.response is None]


BROKER = ApprovalBroker()


class SlackClient:
    def __init__(self, settings: Settings | None = None,
                 broker: ApprovalBroker | None = None) -> None:
        self.settings = settings or get_settings()
        self.broker = broker or BROKER
        self.outbox: list[dict] = []  # offline queue when unconfigured

    @property
    def configured(self) -> bool:
        return bool(self.settings.slack_webhook_url)

    def _post(self, payload: dict) -> bool:
        if not self.configured:
            self.outbox.append(payload)
            return False
        req = urllib.request.Request(
            self.settings.slack_webhook_url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:  # noqa: S310
            return resp.status == 200

    def notify(self, text: str) -> bool:
        return self._post({"channel": self.settings.slack_channel, "text": text})

    def request_approval(self, request: ApprovalRequest,
                         timeout_s: float | None = None) -> ApprovalResponse | None:
        """Register with the broker, notify Slack, block for resolution."""
        self.broker.register(request)
        self._post({
            "channel": self.settings.slack_channel,
            "text": (f"Approval needed: {request.action_type.value} on "
                     f"{request.target_resource} ({request.target_namespace}) — "
                     f"risk {request.risk_level.value}, "
                     f"blast {request.blast_radius_score:.0f}. "
                     f"Resolve via POST /api/v1/approvals/{request.action_id}"),
            "blocks": [{
                "type": "section",
                "text": {"type": "mrkdwn",
                         "text": f"*{request.incident_title}*\n{request.hypothesis_summary}"},
            }],
        })
        timeout = timeout_s if timeout_s is not None else (
            self.settings.approval_timeout_seconds)
        return self.broker.wait(str(request.action_id), timeout)
