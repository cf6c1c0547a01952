"""Weight loading and kernel build helpers."""
