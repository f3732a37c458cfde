"""Configuration, value types and the tensor registry."""
