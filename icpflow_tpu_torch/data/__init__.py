"""Synthetic scenes (numpy only)."""
