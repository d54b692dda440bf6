"""Sharding of the answer pipeline over a grid of devices (parallel/mesh.py)."""
