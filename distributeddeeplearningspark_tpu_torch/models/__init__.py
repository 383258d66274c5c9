"""Models of the port (``nn.Module``s)."""
