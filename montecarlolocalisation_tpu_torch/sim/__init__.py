"""Simulated robots and sensor logs."""
