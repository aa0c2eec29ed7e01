"""Import modules of the port."""
