"""Serving: prefill by decode steps and continuous batching (``driver.py``).
The reference's serving plane (snapshot publishing, replicas, the remote
feed) waits for ROADMAP queue 1 item 7 (f)."""
from .driver import RequestDriver, scan_prefill

__all__ = ["RequestDriver", "scan_prefill"]
