"""Configuration and device selection."""
