"""Inference-graph spec parsing."""
