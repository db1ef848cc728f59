"""Simulator arguments of the port."""
