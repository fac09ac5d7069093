"""Experiment grid runners over the scenario engine.

Counterpart of ``repro.experiments``.  ``python -m repro_torch.experiments.sweep``
drives algorithm x scenario x tau x omega grids through the Simulator
and/or the sharded engine, emitting per-cell JSON artifacts (history +
dense per-round metric streams) and a ``summary.jsonl``: the reproduction
path for the paper's iid/non-iid comparison tables and the
fault-robustness curves.
"""
