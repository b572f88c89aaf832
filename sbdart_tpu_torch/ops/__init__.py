"""Batched small-matrix linear algebra in lane layout (torch)."""
