"""Configuration, device selection, captured calls and the device mesh."""
