"""Online convergence diagnostics for DSE-MVR runs.

Counterpart of ``repro.telemetry.diagnostics``, copied (standard library
only).

The paper's claims are *rate* claims: consensus error ``||X - X̄||²`` and
tracking error ``Σᵢ ||bᵢ - ḡ||²`` decay at rates governed by the spectral
gap, the heterogeneity level and the gradient noise (see also DGT with
local steps, arXiv 2301.01313, and arXiv 2403.15654, which use the same
quantities as the diagnostic axis).  The engines already compute these
on-device per round (``repro_torch.scenarios.metrics``); this module watches the
resulting *streams* online and turns them into judgements:

  * :class:`OnlineStat` — EWMA level + trend per series, windowed log-slope
    for decay-rate estimation, peak tracking;
  * :class:`DiagnosticsMonitor` — feed it per-round observations
    (``observe(step, consensus=..., tracking_err=..., loss=...)`` or a whole
    engine streams dict via ``observe_streams``); it maintains the online
    stats, emits **anomaly events** into the telemetry hub the moment a
    threshold/trend rule fires (stall, divergence, consensus blow-up after
    a membership fault), and renders a :meth:`diagnose` report.

Anomaly rules (all with hysteresis — one event per episode, re-armed when
the condition clears):

``stall``              loss EWMA trend ≈ 0 and stationarity proxy not
                       decaying over the trailing window.
``divergence``         loss (or gradient norm) EWMA grows for
                       ``patience`` consecutive observations, or a
                       non-finite value shows up anywhere.
``consensus_blowup``   consensus error jumps > ``blowup_factor`` × its
                       pre-fault EWMA within ``fault_window`` rounds of a
                       membership-epoch bump (the signature of a resync or
                       ``W_t`` renormalization gone wrong).

Everything is plain host-side float math over scalars that already left the
device — the monitor adds no device syncs and is safe to run per round.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

__all__ = ["OnlineStat", "DiagnosticsMonitor"]


def _finite(x: Optional[float]) -> bool:
    return x is not None and math.isfinite(x)


class OnlineStat:
    """EWMA level/trend + windowed log-slope for one scalar series."""

    def __init__(self, alpha: float = 0.3, window: int = 8):
        self.alpha = float(alpha)
        self.window = int(window)
        self.n = 0
        self.last: Optional[float] = None
        self.ewma: Optional[float] = None
        self.trend = 0.0  # EWMA of successive differences
        self.peak: Optional[float] = None
        self._tail: List[float] = []  # trailing raw values for log-slope

    def update(self, value: float) -> None:
        value = float(value)
        if self.ewma is None:
            self.ewma = value
        else:
            self.trend = (1 - self.alpha) * self.trend + self.alpha * (value - self.last)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * value
        self.last = value
        self.peak = value if self.peak is None else max(self.peak, value)
        self._tail.append(value)
        if len(self._tail) > self.window:
            self._tail.pop(0)
        self.n += 1

    def log_slope(self) -> Optional[float]:
        """Least-squares slope of log(value) over the trailing window —
        the per-round decay exponent (negative = decaying, the healthy
        sign for consensus/tracking/stationarity series)."""
        ys = [math.log(v) for v in self._tail if v > 0.0]
        k = len(ys)
        if k < 3:
            return None
        xs = range(k)
        mx = (k - 1) / 2.0
        my = sum(ys) / k
        num = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        den = sum((x - mx) ** 2 for x in xs)
        return num / den if den else None

    def summary(self) -> Dict[str, Any]:
        return {
            "n": self.n,
            "last": self.last,
            "ewma": self.ewma,
            "trend": self.trend,
            "peak": self.peak,
            "log_slope": self.log_slope(),
        }


#: engine stream name -> monitor series name (identity unless renamed)
_STREAM_SERIES = {
    "consensus": "consensus",
    "tracking_err": "tracking_err",
    "loss": "loss",
    "grad_norm": "grad_norm",
    "replica_drift": "replica_drift",
}


class DiagnosticsMonitor:
    """Watches convergence series online; records anomalies as telemetry
    events; renders a ``diagnose()`` report.

    ``hub`` is an optional :class:`repro_torch.telemetry.Telemetry`; when given,
    each anomaly becomes a first-class event
    ``{"event": "anomaly", "kind": ..., "step": ..., "detail": ...}`` and a
    monotone ``anomalies`` counter sample, so anomalies ship over the same
    drain/export paths as everything else (JSONL, Prometheus, /trace).
    """

    def __init__(self, hub=None, *, alpha: float = 0.3, window: int = 8,
                 patience: int = 4, stall_tol: float = 1e-3,
                 blowup_factor: float = 10.0, fault_window: int = 3):
        self.hub = hub
        self.alpha = float(alpha)
        self.window = int(window)
        self.patience = int(patience)
        self.stall_tol = float(stall_tol)
        self.blowup_factor = float(blowup_factor)
        self.fault_window = int(fault_window)

        self.stats: Dict[str, OnlineStat] = {}
        self.anomalies: List[Dict[str, Any]] = []
        self.steps = 0
        self._grow_streak = 0
        self._stall_streak = 0
        self._active: Dict[str, bool] = {}  # hysteresis latches per kind
        # membership-fault context for the blow-up rule
        self._last_epoch: Optional[int] = None
        self._fault_step: Optional[int] = None
        self._prefault_consensus: Optional[float] = None
        if hub is not None:
            hub.register_stream("anomalies", kind="counter", axis="scalar")

    # ------------------------------------------------------------- intake
    def _stat(self, name: str) -> OnlineStat:
        if name not in self.stats:
            self.stats[name] = OnlineStat(self.alpha, self.window)
        return self.stats[name]

    def observe(self, step: int, *, epoch: Optional[int] = None,
                **series: Optional[float]) -> List[Dict[str, Any]]:
        """Feed one round's scalars; returns anomalies fired this step."""
        fired: List[Dict[str, Any]] = []
        self.steps += 1

        if epoch is not None:
            if self._last_epoch is not None and epoch != self._last_epoch:
                st = self.stats.get("consensus")
                self._fault_step = step
                self._prefault_consensus = st.ewma if st else None
            self._last_epoch = int(epoch)

        for name, value in series.items():
            if value is None:
                continue
            value = float(value)
            if not math.isfinite(value):
                fired += self._fire("divergence", step,
                                    f"non-finite {name} at round {step}")
                continue
            self._stat(name).update(value)

        fired += self._check_divergence(step)
        fired += self._check_stall(step)
        fired += self._check_consensus_blowup(step)
        return fired

    def observe_streams(self, streams: Dict[str, Any],
                        epochs: Optional[List[int]] = None) -> None:
        """Replay a whole engine ``out["streams"]`` dict (arrays indexed by
        round) through :meth:`observe` — the offline entry point used by the
        single-process engines and by tests."""
        series = {
            out_name: list(map(float, streams[in_name]))
            for in_name, out_name in _STREAM_SERIES.items()
            if in_name in streams
        }
        if not series:
            return
        n = min(len(v) for v in series.values())
        for t in range(n):
            epoch = int(epochs[t]) if epochs is not None and t < len(epochs) else None
            self.observe(t, epoch=epoch,
                         **{k: v[t] for k, v in series.items()})

    # ------------------------------------------------------------- rules
    def _fire(self, kind: str, step: int, detail: str) -> List[Dict[str, Any]]:
        if self._active.get(kind):
            return []
        self._active[kind] = True
        anomaly = {"kind": kind, "step": int(step), "detail": detail}
        self.anomalies.append(anomaly)
        if self.hub is not None:
            self.hub.record_event({"event": "anomaly", **anomaly})
            self.hub.record("anomalies", 1.0, step=step, label=kind)
        return [anomaly]

    def _clear(self, kind: str) -> None:
        self._active[kind] = False

    def _check_divergence(self, step: int) -> List[Dict[str, Any]]:
        st = self.stats.get("loss") or self.stats.get("grad_norm")
        if st is None or st.n < 2 or not _finite(st.trend):
            return []
        scale = abs(st.ewma) if _finite(st.ewma) and st.ewma else 1.0
        if st.trend > self.stall_tol * scale:
            self._grow_streak += 1
        else:
            self._grow_streak = 0
            self._clear("divergence")
        if self._grow_streak >= self.patience:
            return self._fire(
                "divergence", step,
                f"loss EWMA rising for {self._grow_streak} rounds "
                f"(trend={st.trend:.3g}, ewma={st.ewma:.3g})")
        return []

    def _check_stall(self, step: int) -> List[Dict[str, Any]]:
        loss = self.stats.get("loss")
        if loss is None or loss.n < self.window:
            return []
        scale = abs(loss.ewma) if _finite(loss.ewma) and loss.ewma else 1.0
        flat = abs(loss.trend) <= self.stall_tol * scale
        # stationarity proxy: gradient norm (or tracking error) should still
        # be decaying if flat loss means "converged" rather than "stuck"
        grad = self.stats.get("grad_norm") or self.stats.get("tracking_err")
        decaying = False
        if grad is not None:
            slope = grad.log_slope()
            decaying = slope is not None and slope < -self.stall_tol
        if flat and grad is not None and not decaying:
            self._stall_streak += 1
        else:
            self._stall_streak = 0
            self._clear("stall")
        if self._stall_streak >= self.patience:
            return self._fire(
                "stall", step,
                f"loss flat (trend={loss.trend:.3g}) with no stationarity "
                f"decay over the last {self.window} rounds")
        return []

    def _check_consensus_blowup(self, step: int) -> List[Dict[str, Any]]:
        if self._fault_step is None:
            return []
        if step - self._fault_step > self.fault_window:
            self._fault_step = None
            self._clear("consensus_blowup")
            return []
        st = self.stats.get("consensus")
        base = self._prefault_consensus
        if st is None or not _finite(st.last) or not _finite(base) or base <= 0:
            return []
        if st.last > self.blowup_factor * base:
            return self._fire(
                "consensus_blowup", step,
                f"consensus error {st.last:.3g} is "
                f"{st.last / base:.1f}x the pre-fault EWMA {base:.3g} "
                f"within {step - self._fault_step} rounds of the epoch bump")
        return []

    # ------------------------------------------------------------- report
    def diagnose(self) -> Dict[str, Any]:
        """One-shot report: per-series online stats, the derived
        effective-heterogeneity proxy and stationarity decay, all anomalies,
        and a coarse verdict (``healthy`` / ``suspect`` / ``unhealthy``)."""
        series = {name: st.summary() for name, st in self.stats.items()}
        tracking = self.stats.get("tracking_err")
        consensus = self.stats.get("consensus")
        grad = self.stats.get("grad_norm") or tracking
        report: Dict[str, Any] = {
            "steps": self.steps,
            "series": series,
            # across-node tracker variance is exactly the quantity the
            # paper's rates charge to heterogeneity once noise is averaged
            "effective_heterogeneity": tracking.ewma if tracking else None,
            "stationarity_decay": grad.log_slope() if grad else None,
            "consensus_decay": consensus.log_slope() if consensus else None,
            "anomalies": list(self.anomalies),
        }
        kinds = {a["kind"] for a in self.anomalies}
        if {"divergence", "consensus_blowup"} & kinds:
            report["verdict"] = "unhealthy"
        elif kinds:
            report["verdict"] = "suspect"
        else:
            report["verdict"] = "healthy"
        return report
