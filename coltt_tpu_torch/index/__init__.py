"""Schema, filter expressions and the bitmap inverted index."""
