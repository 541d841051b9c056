"""Synthetic batches for tests and the chip smoke run."""
