"""Performance models of the port (the roofline of one H100)."""
