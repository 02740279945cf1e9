"""TWILIGHT-TPU: GPU-accelerated multiple sequence alignment engine."""
__version__ = "0.1.0"
