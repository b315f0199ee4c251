"""Launchers: the serving launcher (`serve.py`)."""
