"""Synthetic scalar fields."""
