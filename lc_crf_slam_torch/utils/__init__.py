"""Synthetic RGB-D worlds and TUM trajectory output."""
