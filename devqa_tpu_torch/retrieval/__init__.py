"""Embedding store and top-k search for probe synthesis."""
