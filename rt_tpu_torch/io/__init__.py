"""Image writers (stdlib only: no Pillow)."""
