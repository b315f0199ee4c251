"""Launchers: serving (`serve.py`), training (`train.py`), meshes and the
fleet's mesh smoke (`mesh.py`), and local ranks (`hostdev.py`)."""
