"""Data constants (Bayer CFA layouts)."""
