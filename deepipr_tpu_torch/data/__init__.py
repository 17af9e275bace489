"""Data helpers used to build request batches (normalize, synthetic data)."""
