"""Synthetic measures of the paper's experiments."""
