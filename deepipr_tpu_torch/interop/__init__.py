"""Interop: loading the JAX package's variable trees into port models."""
