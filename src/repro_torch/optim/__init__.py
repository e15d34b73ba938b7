"""The port's optimizer: AdamW, its schedule and gradient utilities
(``adamw``)."""
