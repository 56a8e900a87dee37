"""LM zoo of the port: the dense decoder-only family so far."""
