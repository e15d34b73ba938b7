"""Synthetic data of the port (the numpy part of ``repro.data``)."""
