"""Image writers (PNG and PPM from the standard library, JPEG through
Pillow) and video assembly."""
