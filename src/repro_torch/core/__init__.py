"""Serving half of the paper's compressor, ported to PyTorch."""
