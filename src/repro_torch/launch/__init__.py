"""The train step and device selection."""
