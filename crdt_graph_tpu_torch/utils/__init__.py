"""Process-environment helpers."""
