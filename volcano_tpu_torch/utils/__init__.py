"""Shared low-level utilities."""
