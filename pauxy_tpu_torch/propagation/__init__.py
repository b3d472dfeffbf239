"""Propagators."""
