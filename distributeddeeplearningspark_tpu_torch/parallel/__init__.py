"""Data parallelism over processes: the mesh shape and the collectives."""
