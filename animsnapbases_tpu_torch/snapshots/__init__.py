"""Constraint-projection snapshots of the bases pipeline."""
