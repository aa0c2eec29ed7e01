"""Chain and engine of the port."""
