"""Training: AdamW / SGD-momentum (`optimizer.py`) and the train, prefill
and serve steps (`train_step.py`)."""
