"""Synthetic corpora and query samplers."""
