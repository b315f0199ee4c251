"""Architecture configs: copies of `repro/configs/` (see `base.py`)."""
