"""Scene description and device tables."""
