"""Actions, networks and evaluation of the MEC scheduler, ported to PyTorch."""
