"""The dynamic-evaluation harness."""
