"""Data layer of the port: vocab, segment padding, synthetic fixtures."""
