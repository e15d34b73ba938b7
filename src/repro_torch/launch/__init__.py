"""Drivers: the engine's step functions and the serving entry point."""
