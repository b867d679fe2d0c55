"""Datasets: the in-memory base classes (``memdataset.py``)."""
