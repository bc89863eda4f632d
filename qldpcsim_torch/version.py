"""Version of the PyTorch port (tracks the reference package's version)."""

__version__ = "0.5.0"
