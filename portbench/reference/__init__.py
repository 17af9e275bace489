"""Plain PyTorch reference of the benchmark's models; it imports nothing of
the program it judges."""
