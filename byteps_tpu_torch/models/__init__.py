"""The flagship transformer and parameter conversion."""
