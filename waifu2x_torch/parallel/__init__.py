"""Work splitting for the port. So far the single-device block tiler
(tiles.py); multi-device conversion is not ported yet."""
