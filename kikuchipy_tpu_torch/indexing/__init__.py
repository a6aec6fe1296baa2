"""Similarity metrics and dictionary indexing."""
