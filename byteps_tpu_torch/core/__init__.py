"""Runtime state and the async-handle table."""
