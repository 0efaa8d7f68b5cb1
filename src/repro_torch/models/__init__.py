"""Model layers of the dense decoder serving path."""
