"""Scripted scenarios (the snapshot factories), the interactive session
and the scene helpers of the port's demos."""
