"""Gradient codecs of the PS path: onebit, topk, randomk and dithering in
numpy, the error-feedback and momentum decorators, the level-1
``Compression`` selectors, and the configuration parser shared by the host
chains and the device adapters."""
