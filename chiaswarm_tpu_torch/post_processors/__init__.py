"""Result envelopes: artifacts, thumbnails, grids, error images."""
