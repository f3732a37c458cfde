"""Gradient codecs of the PS path: the onebit codec in numpy, and the
configuration parser shared by the host chains and the device adapters."""
