"""Mesh construction for the distributed paths."""
