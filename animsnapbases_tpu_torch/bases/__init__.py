"""Constraint and position bases of the bases pipeline."""
