"""Device ops of the port: connected components, rank areas, kernels."""
