from .jira import JiraClient
from .slack import BROKER, ApprovalBroker, SlackClient

__all__ = ["ApprovalBroker", "BROKER", "SlackClient", "JiraClient"]
