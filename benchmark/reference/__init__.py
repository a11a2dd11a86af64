"""The plain reference that decides ``correct``."""
