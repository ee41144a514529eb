"""Host-plane utilities: the clock and filesystem seams, async byte
streams, YAML."""
