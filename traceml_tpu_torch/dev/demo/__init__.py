"""Fault-injection demo scenarios: the ground truth of the diagnosis
precision harness (``dev/precision_harness.py``)."""
