"""Device ops of the port: attention and its hand-written CUDA kernel."""
