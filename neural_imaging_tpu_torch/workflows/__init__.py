"""Workflows: the manipulation-classification forward path."""
