"""Multiplexor modules of the port."""
