"""Eval steps and signature detection (the train step is a later slice)."""
