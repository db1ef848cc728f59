"""Helpers: synthetic bases for smokes and tests, invariant checks, phase timing."""
