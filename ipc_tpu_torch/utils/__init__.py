"""Observability, timers, checkpointing, rendering."""
