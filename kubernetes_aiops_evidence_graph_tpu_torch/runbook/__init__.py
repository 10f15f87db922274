from .generator import RunbookGenerator

__all__ = ["RunbookGenerator"]
