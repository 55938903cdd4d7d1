"""Synthetic tabular data for the tree round."""
