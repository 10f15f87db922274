from .hashing import alert_fingerprint, stable_hash
from .padding import bucket_for, pad_to
from .timeutils import minutes_ago, parse_iso, to_epoch_s

__all__ = [
    "alert_fingerprint", "stable_hash",
    "bucket_for", "pad_to",
    "minutes_ago", "parse_iso", "to_epoch_s",
]
