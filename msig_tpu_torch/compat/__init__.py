"""Torch-side checkpoint interop."""
