"""Checkpoints (`checkpoint.py`)."""
