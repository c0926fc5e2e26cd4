"""Batched inference, dataset inference and pseudo-label generation."""
