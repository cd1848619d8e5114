"""Utilities of the port: metrics writing and summaries."""
