"""Device choice, runtime knobs and columnar input."""
