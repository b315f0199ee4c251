"""Serving: the slot-indexed generation engine (`engine.py`)."""
