"""Inference backends (SVI so far)."""
