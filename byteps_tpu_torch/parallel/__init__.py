"""Attention on one device (sequence parallelism is a later slice)."""
