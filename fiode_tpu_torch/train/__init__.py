"""Data (and, in a later slice, training) for the port."""
