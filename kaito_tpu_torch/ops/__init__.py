"""Kernel build and binding helpers."""
