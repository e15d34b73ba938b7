"""Checkpoint store (npz shards + manifest) of the port."""
