"""Network definitions."""
