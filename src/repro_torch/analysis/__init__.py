"""Roofline analysis of the dry-run's counted steps."""
