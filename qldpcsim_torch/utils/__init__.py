"""Auxiliary subsystems of the port: the threefry key operations."""
