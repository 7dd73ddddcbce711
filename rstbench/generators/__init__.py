"""Graph generators, found by the name a configuration gives."""
