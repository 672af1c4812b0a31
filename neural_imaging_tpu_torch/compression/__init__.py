"""Host-side codec helpers (quantization tables)."""
