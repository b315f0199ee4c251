"""Synthetic data: the planted-Markov token stream (`pipeline.py`)."""
