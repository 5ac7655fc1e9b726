"""Device resolution and result-file IO for the port."""
