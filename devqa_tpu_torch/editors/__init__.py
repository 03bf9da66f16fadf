"""Editors: LiveEdit (inference)."""
