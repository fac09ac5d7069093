"""Serving: prefill by decode steps and continuous batching (``driver.py``)
and the serving-plane metrics (``metrics.py``).  The reference's snapshot
publishing, replicas and remote feed wait for ROADMAP queue 1 item 7 (f)."""
from .driver import RequestDriver, scan_prefill
from .metrics import SERVING_STREAM_FIELDS, ServingMetrics

__all__ = ["RequestDriver", "scan_prefill", "ServingMetrics", "SERVING_STREAM_FIELDS"]
