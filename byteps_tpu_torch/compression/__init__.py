"""Gradient codecs of the PS path: onebit, topk, randomk and dithering in
numpy, the error-feedback and momentum decorators, the level-1
``Compression`` selectors, the configuration parser shared by the host
chains and the device adapters, and the lossless wire-frame codec
(``lossless.py``)."""
