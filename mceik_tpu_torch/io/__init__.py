"""Configs with dotted overrides, JSONL metrics."""
