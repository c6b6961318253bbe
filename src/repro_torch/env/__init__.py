"""Wireless channel model, ported to PyTorch."""
