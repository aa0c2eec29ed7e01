"""Container I/O of the port (YUV4MPEG2 only in this slice)."""
