"""Device resolution and timing helpers."""
