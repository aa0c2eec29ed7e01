"""Encoder modules of the port."""
