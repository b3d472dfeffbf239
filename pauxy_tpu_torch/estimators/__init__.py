"""Estimators."""
