"""EVQA loading, t×i probe synthesis, xym label semantics, image providers."""
