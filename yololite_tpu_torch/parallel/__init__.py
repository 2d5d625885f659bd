"""Data- and spatial-parallel training over processes (port of `parallel/`):
`dist.py` is the counterpart of `mesh.py`'s mesh and its `data` axis,
`spatial.py` of its `spatial` axis."""
