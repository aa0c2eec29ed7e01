"""Video filters of the port."""
