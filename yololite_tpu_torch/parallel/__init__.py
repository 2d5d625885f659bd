"""Data-parallel training over processes (port of `parallel/`): `dist.py` is
the counterpart of `mesh.py`'s `data` axis."""
