"""Configuration objects of the port."""
