"""Experiments that run on the card: the kernel variant lab."""
