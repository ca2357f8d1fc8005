"""Compiler (graph → relational pipeline) and the tensor executor."""
