"""The benchmark's frozen operation, byte and peak arithmetic."""
