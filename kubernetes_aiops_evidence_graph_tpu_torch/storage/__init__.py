from .sqlite import Database, DuplicateIncidentError

__all__ = ["Database", "DuplicateIncidentError"]
