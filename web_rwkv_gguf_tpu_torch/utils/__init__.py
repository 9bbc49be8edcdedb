"""Synthetic model files for tests and the chip smoke run."""
