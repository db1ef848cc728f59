"""Helpers for smokes and tests."""
